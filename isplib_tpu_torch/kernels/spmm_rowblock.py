"""Sum-SpMM over a v1 row-block plan: ``csrc/spmm_rowblock.cu`` and its plain
version.

Counterpart of ``isplib_tpu/kernels/spmm_pallas.py::_spmm_rowblock_kernel``
(K10, entry ``spmm_tiled``), the kernel of ``build_tiling(version=1)``.  The
port computes in fp32; the TPU kernel multiplies bf16 one-hot matrices on
the chip.  The kernel walks the plan's schedule (``TiledPlan.sched``): a
warp per work item of one row's real slots, its sum in registers, stored
once.  For a CUDA tensor the wrapper launches the kernel or raises; the
plain version runs only for a CPU tensor (and in ``chip_smoke.py``, which
holds the kernel against it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.reference import _SUM_EDGE_FEATURE_BYTES, _chunks
from ..sparse.tiling import TiledPlan
from . import build

__all__ = ["spmm_rowblock", "spmm_rowblock_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _check(plan: TiledPlan, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.device}")


def spmm_rowblock_plain(plan: TiledPlan, x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, fp32, over chunks of features:
    ``(num_rows, K)``.  Slots of value 0 (the pads) are left out, as the
    kernel leaves them out."""
    out = x.new_zeros(plan.num_rows, x.shape[1])
    s = plan.slots()
    keep = s["val"] != 0
    row, col, val = s["row"][keep], s["col"][keep], s["val"][keep]
    for feats in _chunks(row.shape[0], x.shape[1], _SUM_EDGE_FEATURE_BYTES,
                         x.element_size()):
        out[:, feats] = out[:, feats].index_add(
            0, row, val[:, None] * x[:, feats].index_select(0, col))
    return out


@functools.cache
def _lib():
    fn = build.load("spmm_rowblock").spmm_rowblock_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_rowblock(plan: TiledPlan, x: torch.Tensor) -> torch.Tensor:
    """``out (num_rows, K) = plan's edges @ x``, fp32."""
    global LAUNCHES
    _check(plan, x)
    if x.device.type == "cpu":
        return spmm_rowblock_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_rowblock runs on cuda or cpu, not {x.device}")
    if plan.sched is None:
        raise ValueError("the plan has no K10 schedule: build it with "
                         "build_plan_v1_arrays")
    k = x.shape[1]
    out = torch.zeros(plan.num_rows, k, dtype=torch.float32, device=x.device)
    s = plan.sched
    if s.nseg == 0 or k == 0:
        return out
    err = _lib()(plan.edges.data_ptr(), plan.ct_ids.data_ptr(),
                 s.order.data_ptr(), s.row_ptr.data_ptr(),
                 s.seg_ptr.data_ptr(), s.seg_row.data_ptr(), x.data_ptr(),
                 out.data_ptr(), s.nseg, plan.eb, plan.ct, k, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spmm_rowblock launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
