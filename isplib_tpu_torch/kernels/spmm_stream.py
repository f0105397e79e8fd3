"""Residual half of the hybrid SpMM: ``csrc/spmm_stream.cu`` and its plain
version.

Counterpart of ``isplib_tpu/kernels/spmm_pallas_v4.py::_v4_kernel`` (K1).
It adds into the output of the dense half in place, which saves a second
(R, K) buffer and a pass to sum the halves.  For a CUDA tensor the wrapper
launches the kernel or raises; the plain version runs only for a CPU tensor
(and in ``chip_smoke.py``, which holds the kernel against the plain function
evaluated in float64, :func:`spmm_stream_oracle`).  An odd K reaches the
kernel as a view of x padded with zero columns to a multiple of 4
(``minmax_walk.pitched``), so its rows load as float4s; out keeps its own
pitch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.reference import _SUM_EDGE_FEATURE_BYTES, _chunks
from ..sparse.tiling_v5 import HybridPlan
from ..utils.profiling import span
from . import build
from .minmax_walk import pitched

__all__ = ["spmm_stream", "spmm_stream_plain", "spmm_stream_oracle",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _check(plan: HybridPlan, x: torch.Tensor, out: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if out.shape != (plan.num_rows, x.shape[1]):
        raise ValueError(f"out must be ({plan.num_rows}, {x.shape[1]}), "
                         f"got {tuple(out.shape)}")
    for name, t in (("x", x), ("out", out)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != plan.res_col.device:
            raise ValueError(f"{name} is on {t.device}, the plan on "
                             f"{plan.res_col.device}")


def spmm_stream_plain(plan: HybridPlan, x: torch.Tensor,
                      out: torch.Tensor) -> None:
    """``out += residual edges @ x`` in plain PyTorch, in x's precision,
    over chunks of features whose (residual edges, chunk) temporaries stay
    within ``CHUNK_BYTES``.  Each output column is a sum over the same
    edges in the same order as in one piece."""
    rows = torch.repeat_interleave(
        torch.arange(plan.num_rows, device=x.device),
        plan.res_rowptr.diff().long())
    col, val = plan.res_col, plan.res_val[:, None]
    for feats in _chunks(col.shape[0], x.shape[1], _SUM_EDGE_FEATURE_BYTES,
                         x.element_size()):
        out[:, feats].index_add_(
            0, rows, val * x[:, feats].index_select(0, col))


def spmm_stream_oracle(plan: HybridPlan, x: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """``out + residual edges @ x`` evaluated in float64, a new float64
    tensor (``out`` is left as it is), its temporaries within
    ``CHUNK_BYTES`` as the plain version's are.  The fp32 plain version
    sums by ``index_add_`` in a run-to-run order on a card, as the
    kernel's split rows do; in float64 the oracle's own rounding stays out
    of the comparison."""
    want = out.to(torch.float64, copy=True)
    spmm_stream_plain(plan, x.double(), want)
    return want


@functools.cache
def _lib():
    fn = build.load("spmm_stream").spmm_stream_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_stream(plan: HybridPlan, x: torch.Tensor, out: torch.Tensor) -> None:
    """``out (num_rows, K) += residual edges @ x``, in place."""
    global LAUNCHES
    with span("isplib.K1"):
        _check(plan, x, out)
        if x.device.type == "cpu":
            spmm_stream_plain(plan, x, out)
            return
        if x.device.type != "cuda":
            raise ValueError(f"spmm_stream runs on cuda or cpu, not "
                             f"{x.device}")
        if plan.nseg == 0 or x.shape[1] == 0:
            return
        xp = pitched(x)
        err = _lib()(plan.res_rowptr.data_ptr(), plan.res_col.data_ptr(),
                     plan.res_val.data_ptr(), plan.seg_ptr.data_ptr(),
                     plan.seg_row.data_ptr(), xp.data_ptr(), out.data_ptr(),
                     plan.nseg, x.shape[1], xp.stride(0), x.device.index,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"spmm_stream launch failed: CUDA error {err}")
        LAUNCHES += 1
