"""SDDMM over the CSR edges: ``csrc/sddmm.cu`` and its plain version.

Counterpart of ``isplib_tpu/kernels/sddmm_pallas.py::_sddmm_kernel`` (K4):
``out[e] = <a[row[e]], b[col[e]]>`` for every real edge, in CSR order (an
edge's position is its id), ``(len(col),)`` float32 with 0 on pad edges.
It computes ``grad_value`` of sum/mean SpMM on a tiled graph and the public
``sddmm``.  fp32 on both sides; only the order of the K-sum differs.  For a
CUDA tensor the wrapper launches the kernel or raises; the plain version
runs only for a CPU tensor (and in ``chip_smoke.py``, which holds the
kernel against it).  An odd K reaches the kernel as views of a and b padded
with zero columns to a multiple of 4 (``minmax_walk.pitched``), which add 0
to every dot.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import reference
from ..sparse.tiling_v4mm import MinMaxPlan
from . import build
from .minmax_walk import pitched

__all__ = ["sddmm", "sddmm_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _check(plan: MinMaxPlan, col: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> None:
    if a.dim() != 2 or a.shape[0] != plan.num_rows:
        raise ValueError(f"a must be ({plan.num_rows}, K), got "
                         f"{tuple(a.shape)}")
    if b.dim() != 2 or b.shape != (plan.num_cols, a.shape[1]):
        raise ValueError(f"b must be ({plan.num_cols}, {a.shape[1]}), got "
                         f"{tuple(b.shape)}")
    if col.dim() != 1 or col.shape[0] < plan.nnz:
        raise ValueError(f"col must be one (>= {plan.nnz},) edge list, got "
                         f"{tuple(col.shape)}")
    for name, t, dtype in (("a", a, torch.float32), ("b", b, torch.float32),
                           ("col", col, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != plan.seg_ptr.device:
            raise ValueError(f"{name} is on {t.device}, the plan on "
                             f"{plan.seg_ptr.device}")


def sddmm_plain(plan: MinMaxPlan, col: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the reference formulation over
    the plan's edges)."""
    out = a.new_zeros(col.shape[0])
    out[:plan.nnz] = reference.sddmm_dot_raw(plan.edge_rows(),
                                             col[:plan.nnz], a, b)
    return out


@functools.cache
def _lib():
    fn = build.load("sddmm").sddmm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sddmm(plan: MinMaxPlan, col: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Per-edge ``<a[row e], b[col e]>`` of the CSR edges cut by ``plan``
    (``fwd_mm`` of a TiledGraph; ``col`` the graph's padded column ids),
    ``(len(col),)`` float32, 0 on pad edges."""
    global LAUNCHES
    _check(plan, col, a, b)
    if a.device.type == "cpu":
        return sddmm_plain(plan, col, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"sddmm runs on cuda or cpu, not {a.device}")
    out = torch.zeros(col.shape[0], dtype=torch.float32, device=a.device)
    if plan.nnz == 0 or a.shape[1] == 0:
        return out
    ap, bp = pitched(a), pitched(b)  # one row pitch, set by K
    err = _lib()(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
                 col.data_ptr(), ap.data_ptr(), bp.data_ptr(), out.data_ptr(),
                 plan.nseg, a.shape[1], ap.stride(0), a.device.index,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"sddmm launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
