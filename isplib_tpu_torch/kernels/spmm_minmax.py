"""Max/min SpMM with winning edge ids over a with-eids v2 cell plan:
``csrc/spmm_minmax.cu`` and its plain version.

Counterpart of ``isplib_tpu/kernels/spmm_minmax.py::_minmax_kernel`` (K7),
the sharded path's max/min kernel: ``out[r, k]`` is the max (or min) over
the plan's edges e of row r of ``val[e] * x[col[e], k]`` and ``arg[r, k]``
the lowest edge id (the plan's id plane) that attains it; empty rows give
0 and ``sentinel``.  out is ``sign · (sign · product + 0.0)`` of the winner,
its product with a zero made +0.0 before the sign of min is put back, as
the TPU kernel gives it.  Exact fp32, so kernel and plain version agree bit
for bit.  The kernel walks the plan's schedule (``TiledPlanV2.mm_sched``,
the max/min walk shared with K3) over the real slots alone.  For a CUDA
tensor the wrapper launches the kernel or raises (a plan without its
schedule too); the plain version runs only for a CPU tensor (and in
``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.reference import _ARG_EDGE_FEATURE_BYTES, _chunks
from ..ops.semiring import Reduce
from ..sparse.tiling_v2 import TiledPlanV2
from . import build
from .minmax_walk import Args, launch_args, pitched
from .spmm_v2 import check_operand

__all__ = ["spmm_minmax_v2", "spmm_minmax_v2_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _sign(plan: TiledPlanV2, reduce, sentinel: int) -> float:
    reduce = Reduce.of(reduce)
    if reduce not in (Reduce.MAX, Reduce.MIN):
        raise ValueError(f"spmm_minmax_v2 reduces max or min, not "
                         f"{reduce.value}")
    if not plan.with_eids:
        raise ValueError("spmm_minmax_v2 needs a plan built with_eids=True")
    if not -2**31 <= sentinel < 2**31:
        raise ValueError(f"sentinel {sentinel} is not an int32")
    return -1.0 if reduce is Reduce.MIN else 1.0


def spmm_minmax_v2_plain(plan: TiledPlanV2, x: torch.Tensor, reduce,
                         sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, over chunks of features:
    ``(out (R, K) float32, arg (R, K) int32)``."""
    sign = _sign(plan, reduce, sentinel)
    num_rows, k = plan.num_rows, x.shape[1]
    out = x.new_zeros(num_rows, k)
    arg = torch.full((num_rows, k), sentinel, dtype=torch.int32,
                     device=x.device)
    if plan.fill == 0.0:
        return out, arg
    s = plan.slots()
    keep = s["eid"] >= 0
    row, col, val = s["row"][keep], s["col"][keep], s["val"][keep]
    eid = s["eid"][keep].long()[:, None]
    none = torch.iinfo(torch.int64).max
    for feats in _chunks(row.shape[0], k, _ARG_EDGE_FEATURE_BYTES):
        cmp = sign * (val[:, None] * x[:, feats].index_select(0, col))
        idx = row[:, None].expand_as(cmp)
        best = x.new_full((num_rows, cmp.shape[1]), float("-inf"))
        best.scatter_reduce_(0, idx, cmp, "amax")
        win = torch.full(best.shape, none, dtype=torch.int64,
                         device=x.device)
        win.scatter_reduce_(0, idx, torch.where(
            cmp == best.index_select(0, row), eid, none), "amin")
        hit = win != none
        out[:, feats] = torch.where(hit, sign * (best + 0.0), 0.0)
        arg[:, feats] = torch.where(hit, win, sentinel).to(torch.int32)
    return out, arg


@functools.cache
def _lib():
    fn = build.load("spmm_minmax").spmm_minmax_v2_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(Args), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_minmax_v2(plan: TiledPlanV2, x: torch.Tensor, reduce,
                   sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Max/min SpMM of the with-eids plan times x → ``(out (R, K) float32,
    arg (R, K) int32)``; ``sentinel`` is the arg of empty rows (the sharded
    path passes a pad slot of the shard's edge arrays).

    On CUDA a call is up to three launches on the current stream, counted as
    one in ``LAUNCHES`` (as K3's: ``minmax_walk.cuh``)."""
    global LAUNCHES
    sign = _sign(plan, reduce, sentinel)
    check_operand(plan, x)
    if x.device.type == "cpu":
        return spmm_minmax_v2_plain(plan, x, reduce, sentinel)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_minmax_v2 runs on cuda or cpu, not "
                         f"{x.device}")
    s = plan.mm_sched
    if s is None:
        raise ValueError("the plan has no K7 schedule: build it with "
                         "build_plan_v2_arrays(..., with_eids=True)")
    k = x.shape[1]
    if plan.fill == 0.0 or k == 0:
        return (x.new_zeros(plan.num_rows, k),
                torch.full((plan.num_rows, k), sentinel, dtype=torch.int32,
                           device=x.device))
    out = torch.empty(plan.num_rows, k, dtype=torch.float32, device=x.device)
    arg = torch.empty(plan.num_rows, k, dtype=torch.int32, device=x.device)
    scratch = torch.empty(s.nsplit, k, dtype=torch.int64, device=x.device)
    x = pitched(x)
    args = launch_args(s, x, out, arg, scratch, plan.num_rows,
                       plan.num_cols, k, sign < 0, sentinel)
    err = _lib()(plan.edges.data_ptr(), s.chunk_col.data_ptr(), plan.eb,
                 ctypes.byref(args), x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spmm_minmax_v2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, arg
