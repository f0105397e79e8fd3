"""Sum-SpMM over a v2 cell plan: ``csrc/spmm_v2.cu`` and its plain version.

Counterpart of ``isplib_tpu/kernels/spmm_pallas_v2.py::_spmm_v2_kernel``
(K8), the sharded path's sum kernel under ``tiling={"version": 2}``, the
kernel of ``build_tiling(version=2)`` and the residual half of version 3.  The
port computes in fp32; the TPU kernel rounds each product to bf16.  For a
CUDA tensor the wrapper launches the kernel or raises; the plain version
runs only for a CPU tensor (and in ``chip_smoke.py``, which holds the
kernel against it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops.reference import _SUM_EDGE_FEATURE_BYTES, _chunks
from ..sparse.tiling_v2 import TiledPlanV2
from . import build

__all__ = ["spmm_v2", "spmm_v2_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def check_operand(plan: TiledPlanV2, x: torch.Tensor) -> None:
    """x must be the plan's (num_cols, K) float32, contiguous, on its
    device (the v2 kernels' shared contract)."""
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.device}")


def spmm_v2_plain(plan: TiledPlanV2, x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, fp32, over chunks of features:
    ``(num_rows, K)``.  Slots of value 0 (the pads) are left out, as the
    kernel leaves them out."""
    out = x.new_zeros(plan.num_rows, x.shape[1])
    if plan.fill == 0.0:
        return out
    s = plan.slots()
    keep = s["val"] != 0
    row, col, val = s["row"][keep], s["col"][keep], s["val"][keep]
    for feats in _chunks(row.shape[0], x.shape[1], _SUM_EDGE_FEATURE_BYTES):
        out[:, feats] = out[:, feats].index_add(
            0, row, val[:, None] * x[:, feats].index_select(0, col))
    return out


@functools.cache
def _lib():
    fn = build.load("spmm_v2").spmm_v2_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_v2(plan: TiledPlanV2, x: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out (num_rows, K) += plan's edges @ x``, fp32, into zeros when
    ``out`` is None (the v3 hybrid passes its dense half's output);
    returns ``out``."""
    global LAUNCHES
    check_operand(plan, x)
    k = x.shape[1]
    if out is not None and (out.shape != (plan.num_rows, k)
                            or out.dtype != torch.float32
                            or not out.is_contiguous()
                            or out.device != x.device):
        raise ValueError(f"out must be a contiguous ({plan.num_rows}, {k}) "
                         f"float32 tensor on {x.device}")
    if x.device.type == "cpu":
        part = spmm_v2_plain(plan, x)
        return part if out is None else out.add_(part)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_v2 runs on cuda or cpu, not {x.device}")
    if out is None:
        out = torch.zeros(plan.num_rows, k, dtype=torch.float32,
                          device=x.device)
    if plan.fill == 0.0 or k == 0:
        return out
    err = _lib()(plan.edges.data_ptr(), plan.rb_locals.data_ptr(),
                 plan.cell_starts.data_ptr(), x.data_ptr(), out.data_ptr(),
                 plan.nc, plan.n_cells, plan.planes, plan.eb, plan.rb,
                 plan.ct, plan.nct, plan.nrb_s, plan.num_rows, plan.num_cols,
                 k, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spmm_v2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
