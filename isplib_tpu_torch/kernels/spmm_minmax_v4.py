"""Max/min SpMM with winning edge ids: ``csrc/spmm_minmax_v4.cu`` and its
plain version.

Counterpart of ``isplib_tpu/kernels/spmm_minmax_v4.py::_v4mm_kernel`` (K3):
``out[r, k]`` is the max (or min) over the edges e of row r of
``value[e] * x[col[e], k]`` and ``arg[r, k]`` the lowest edge id that
attains it; empty rows give 0 and ``sentinel``.  Exact fp32, so kernel and
plain version agree bit for bit.  The kernel walks the plan's schedule
(``MinMaxPlan.sched``, the max/min walk shared with K7): warps that own up
to N edges of a row gather its x rows.  For a CUDA tensor the wrapper launches the
kernel or raises (a plan without its schedule too); the plain version runs
only for a CPU tensor (and in ``chip_smoke.py``, which holds the kernel
against it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.reference import _ARG_EDGE_FEATURE_BYTES, _chunks
from ..ops.semiring import Reduce
from ..sparse.tiling_v4mm import MinMaxPlan
from ..utils.profiling import span
from . import build
from .minmax_walk import Args, launch_args, pitched

__all__ = ["spmm_minmax_v4", "spmm_minmax_v4_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _negate(reduce) -> bool:
    reduce = Reduce.of(reduce)
    if reduce not in (Reduce.MAX, Reduce.MIN):
        raise ValueError(f"spmm_minmax_v4 reduces max or min, not "
                         f"{reduce.value}")
    return reduce is Reduce.MIN


def _check(plan: MinMaxPlan, col: torch.Tensor, value: torch.Tensor,
           x: torch.Tensor, sentinel: int) -> None:
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if col.dim() != 1 or col.shape != value.shape or col.shape[0] < plan.nnz:
        raise ValueError(f"col and value must be one (>= {plan.nnz},) edge "
                         f"list, got {tuple(col.shape)} and "
                         f"{tuple(value.shape)}")
    for name, t, dtype in (("x", x, torch.float32), ("col", col, torch.int32),
                           ("value", value, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != plan.seg_ptr.device:
            raise ValueError(f"{name} is on {t.device}, the plan on "
                             f"{plan.seg_ptr.device}")
    if not plan.nnz <= sentinel < 2**31:
        raise ValueError(f"sentinel {sentinel} must be a pad edge id, in "
                         f"[{plan.nnz}, 2**31)")


def spmm_minmax_v4_plain(plan: MinMaxPlan, col: torch.Tensor,
                         value: torch.Tensor, x: torch.Tensor, reduce,
                         sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, over chunks of features (as the
    reference path runs): ``(out (R, K) float32, arg (R, K) int32)``."""
    sign = -1.0 if _negate(reduce) else 1.0
    nnz, num_rows, k = plan.nnz, plan.num_rows, x.shape[1]
    out = x.new_zeros(num_rows, k)
    arg = torch.full((num_rows, k), sentinel, dtype=torch.int32,
                     device=x.device)
    if nnz == 0:
        return out, arg
    row = plan.edge_rows()
    col, value = col[:nnz].long(), value[:nnz]
    eids = torch.arange(nnz, device=x.device)[:, None]
    for feats in _chunks(nnz, k, _ARG_EDGE_FEATURE_BYTES):
        xs = x[:, feats]
        cmp = sign * (value[:, None] * xs.index_select(0, col))
        idx = row[:, None].expand_as(cmp)
        best = x.new_full((num_rows, cmp.shape[1]), float("-inf"))
        best.scatter_reduce_(0, idx, cmp, "amax")
        eid = torch.where(cmp == best.index_select(0, row), eids, sentinel)
        win = torch.full_like(best, sentinel, dtype=torch.int64)
        win.scatter_reduce_(0, idx, eid, "amin")
        hit = win < nnz
        w = win.clamp(max=nnz - 1)
        # the winner's own product, so the sign of a zero is the winner's
        prod = value[w] * xs.gather(0, col[w])
        out[:, feats] = torch.where(hit, prod, 0.0)
        arg[:, feats] = win.to(torch.int32)
    return out, arg


@functools.cache
def _lib():
    fn = build.load("spmm_minmax_v4").spmm_minmax_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(Args),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_minmax_v4(plan: MinMaxPlan, col: torch.Tensor, value: torch.Tensor,
                   x: torch.Tensor, reduce,
                   sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Max/min SpMM of the CSR edges (``col``, ``value``; padded, CSR order)
    cut by ``plan``, times x → ``(out (R, K) float32, arg (R, K) int32)``.
    ``sentinel`` is the arg of empty rows: the dispatcher passes the graph's
    ``nnz_padded - 1``.

    On CUDA a call is up to three launches on the current stream, counted
    as one in ``LAUNCHES``: a pre-pass (rows without edges, the split rows'
    scratch), the walk, the split rows' decode.  An odd K reads a copy of
    x padded to a multiple of 4."""
    global LAUNCHES
    with span("isplib.K3"):
        negate = _negate(reduce)
        _check(plan, col, value, x, sentinel)
        if x.device.type == "cpu":
            return spmm_minmax_v4_plain(plan, col, value, x, reduce, sentinel)
        if x.device.type != "cuda":
            raise ValueError(f"spmm_minmax_v4 runs on cuda or cpu, not "
                             f"{x.device}")
        if plan.sched is None:
            raise ValueError("the plan has no K3 schedule: build it with "
                             "build_minmax_plan(..., schedule=True) or "
                             "build_tiling")
        k = x.shape[1]
        out = torch.empty(plan.num_rows, k, dtype=torch.float32,
                          device=x.device)
        arg = torch.empty(plan.num_rows, k, dtype=torch.int32,
                          device=x.device)
        if plan.num_rows == 0 or k == 0:
            return out, arg
        s = plan.sched
        scratch = torch.empty(s.nsplit, k, dtype=torch.int64,
                              device=x.device)
        x = pitched(x)
        args = launch_args(s, x, out, arg, scratch, plan.num_rows,
                           plan.num_cols, k, negate, sentinel)
        err = _lib()(col.data_ptr(), value.data_ptr(), ctypes.byref(args),
                     x.device.index,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"spmm_minmax_v4 launch failed: CUDA error "
                               f"{err}")
        LAUNCHES += 1
        return out, arg
