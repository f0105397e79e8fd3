"""GAT's attention over a tiled graph: ``csrc/gat_attention.cu`` and the
plain version of each of its kernels.

Replaces no TPU kernel (the JAX package runs an attention whose edge
values need a gradient through XLA); see the source's note.  Three
functions, each over a ``MinMaxPlan``'s segments (``fwd_mm`` of a
TiledGraph walks the CSR, ``bwd_mm`` the CSC), all in fp32:

* ``forward``: each row's ``lse`` (two passes, the max and the sum) and
  ``out[r] = Σ α x[c]`` head by head;
* ``backward_x``: ``dx[c] = Σ α g[r]`` over the CSC (α recomputed from the
  scores and ``lse``);
* ``backward_e``: ∂z of every entry, summed by row into ``ds_dst`` over
  the CSR segments and, stored by CSR position, by column into ``ds_src``
  over the CSC segments (``bwd_mm``, through ``csc2csr``).

Every row's entries are its real edges that are not self loops and one
self loop the kernels add (``ops/reference.py`` ``attention_edges``).  x,
g and out are (N, H·Cp) with each head padded to Cp, a multiple of 4
features (the caller pads, ``ops/attention.py``), at most 1024 columns and
8 heads.  For a CUDA tensor a wrapper launches its kernel or raises; a CPU
tensor runs the plain version, the formulas of ``ops/reference.py`` over
the plan's entries.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import reference
from ..sparse.tiling_v4mm import MinMaxPlan
from . import build

__all__ = ["forward", "backward_x", "backward_e", "LAUNCHES", "BY_KERNEL",
           "KERNELS", "MAX_HEADS", "MAX_WIDTH"]

KERNELS = ("att_stats", "att_gather", "att_bwd_e", "att_colsum")
LAUNCHES = 0  # kernel launches since the count was last set to 0
# the same launches by kernel; set it to ``dict.fromkeys(KERNELS, 0)``
# with LAUNCHES
BY_KERNEL = dict.fromkeys(KERNELS, 0)
MAX_HEADS = 8
MAX_WIDTH = 1024

_POINTERS = ("seg_ptr", "seg_row", "seg_slot", "nbr", "x", "g", "y", "ss",
             "sd", "lse", "m", "l", "out", "dss", "dsd", "dz")


class Args(ctypes.Structure):
    """``Args`` of ``csrc/gat_attention.cu``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _POINTERS]
                + [(f, ctypes.c_int) for f in ("nseg", "heads", "kp4", "cp4")]
                + [("slope", ctypes.c_float)])


@functools.cache
def _lib():
    lib = build.load("gat_attention")
    for name, extra in (("att_stats_launch", 1), ("att_gather_launch", 1),
                        ("att_bwd_e_launch", 0), ("att_colsum_launch", 0)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.POINTER(Args)] + [ctypes.c_int] * (extra + 1)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(plan: MinMaxPlan, nbr: torch.Tensor, x: torch.Tensor,
           scores: tuple) -> None:
    h = scores[0].shape[1]
    if not 1 <= h <= MAX_HEADS:
        raise ValueError(f"{h} heads: the kernels take 1 to {MAX_HEADS}")
    if x.dim() != 2 or x.shape[1] % (4 * h) or x.shape[1] > MAX_WIDTH:
        raise ValueError(f"x must be (N, H·Cp) with Cp a multiple of 4 and "
                         f"at most {MAX_WIDTH} columns, got {tuple(x.shape)}"
                         f" at {h} heads")
    n = plan.num_rows
    if plan.num_cols != n or x.shape[0] != n:
        raise ValueError(f"the attention needs a square plan and x of its "
                         f"{n} rows, got {plan.num_rows}×{plan.num_cols} "
                         f"and {tuple(x.shape)}")
    for t in scores:
        if t.shape != (n, h):
            raise ValueError(f"scores must be ({n}, {h}), got "
                             f"{tuple(t.shape)}")
    for t in (x, *scores):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("x and the scores must be contiguous float32")
        if t.device != plan.seg_ptr.device:
            raise ValueError(f"an operand is on {t.device}, the plan on "
                             f"{plan.seg_ptr.device}")
    if nbr.dtype != torch.int32 or nbr.shape[0] < plan.nnz:
        raise ValueError("nbr must be the graph's int32 col or csc_col")


def _launch(fn: str, a: Args, flag, dev: torch.device) -> None:
    global LAUNCHES
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    args = (ctypes.byref(a),) + (() if flag is None else (flag,))
    err = getattr(lib, fn)(*args, dev.index, stream)
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")
    LAUNCHES += 1
    BY_KERNEL[fn.removesuffix("_launch")] += 1


def _args(plan: MinMaxPlan, nbr, heads: int, kp: int, slope: float,
          **ptrs) -> Args:
    vals = {f: (ptrs[f].data_ptr() if f in ptrs else None)
            for f in _POINTERS[4:]}
    return Args(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
                plan.seg_slot.data_ptr(), nbr.data_ptr(),
                *(vals[f] for f in _POINTERS[4:]),
                plan.nseg, heads, kp // 4, kp // 4 // heads, slope)


def _entries(plan: MinMaxPlan, nbr: torch.Tensor):
    """The plan's (row, neighbour) entries with the self loops the kernels
    add: (dst, src) of the CSR, or (column, row) of the CSC."""
    return reference.attention_edges(plan.edge_rows(), nbr, plan.nnz,
                                     plan.num_rows)


def _zero_split_rows(t: torch.Tensor, plan: MinMaxPlan) -> None:
    if plan.nsplit:
        t.index_fill_(0, plan.split_rows.long(), 0.0)


def forward(plan: MinMaxPlan, col: torch.Tensor, x: torch.Tensor,
            s_src: torch.Tensor, s_dst: torch.Tensor, slope: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) over the CSR segments of ``plan`` (``fwd_mm``; ``col``
    the graph's columns): out (N, H·Cp), lse (N, H)."""
    _check(plan, col, x, (s_src, s_dst))
    h, n = s_src.shape[1], plan.num_rows
    if x.device.type == "cpu":
        dst, src = _entries(plan, col)
        lse = reference.attention_lse(dst, src, s_src, s_dst, n, slope)
        alpha = reference.attention_alpha(dst, src, s_src, s_dst, lse, slope)
        return reference.attention_sum(dst, src, alpha, x, n), lse
    m = torch.full((n, h), float("-inf"), device=x.device)
    lsum = torch.zeros((n, h), device=x.device)
    a = _args(plan, col, h, x.shape[1], slope, x=x, ss=s_src, sd=s_dst, m=m,
              l=lsum)
    _launch("att_stats_launch", a, 0, x.device)
    _launch("att_stats_launch", a, 1, x.device)
    lse = m.add_(lsum.log_())
    out = torch.empty_like(x)
    _zero_split_rows(out, plan)
    a = _args(plan, col, h, x.shape[1], slope, x=x, ss=s_src, sd=s_dst,
              lse=lse, out=out)
    _launch("att_gather_launch", a, 0, x.device)
    return out, lse


def backward_x(plan_t: MinMaxPlan, csc_col: torch.Tensor, g: torch.Tensor,
               s_src: torch.Tensor, s_dst: torch.Tensor, lse: torch.Tensor,
               slope: float) -> torch.Tensor:
    """dx (N, H·Cp) = Σ α g[r] over the CSC segments of ``plan_t``
    (``bwd_mm``; ``csc_col`` the graph's: each CSC entry's row r)."""
    _check(plan_t, csc_col, g, (s_src, s_dst, lse))
    h, n = s_src.shape[1], plan_t.num_rows
    if g.device.type == "cpu":
        col_of, row_of = _entries(plan_t, csc_col)
        alpha = reference.attention_alpha(row_of, col_of, s_src, s_dst, lse,
                                          slope)
        return reference.attention_sum(col_of, row_of, alpha, g, n)
    out = torch.empty_like(g)
    _zero_split_rows(out, plan_t)
    a = _args(plan_t, csc_col, h, g.shape[1], slope, x=g, ss=s_src,
              sd=s_dst, lse=lse, out=out)
    _launch("att_gather_launch", a, 1, g.device)
    return out


def backward_e(plan: MinMaxPlan, col: torch.Tensor, plan_t: MinMaxPlan,
               csc2csr: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
               x: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
               lse: torch.Tensor, slope: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ds_src, ds_dst), each (N, H): ∂z of every entry of the CSR
    segments of ``plan`` summed by column (over the CSC segments of
    ``plan_t``, reading ∂z through ``csc2csr``) and by row."""
    _check(plan, col, x, (s_src, s_dst, lse))
    _check(plan_t, csc2csr, x, (s_src, s_dst, lse))
    for t in (g, out):
        if t.shape != x.shape or not t.is_contiguous():
            raise ValueError("g and out must be contiguous, shaped as x")
    h, n = s_src.shape[1], plan.num_rows
    if x.device.type == "cpu":
        dst, src = _entries(plan, col)
        dz = reference.attention_edge_grad(dst, src, s_src, s_dst, lse, g,
                                           out, x, slope)
        return (dz.new_zeros(n, h).index_add_(0, src, dz),
                dz.new_zeros(n, h).index_add_(0, dst, dz))
    dss = torch.zeros((n, h), device=x.device)
    dsd = torch.zeros((n, h), device=x.device)
    dz = torch.empty((plan.nnz, h), device=x.device)
    a = _args(plan, col, h, x.shape[1], slope, x=x, g=g, y=out, ss=s_src,
              sd=s_dst, lse=lse, dss=dss, dsd=dsd, dz=dz)
    _launch("att_bwd_e_launch", a, None, x.device)
    a = _args(plan_t, csc2csr, h, x.shape[1], slope, dss=dss, dz=dz)
    _launch("att_colsum_launch", a, None, x.device)
    return dss, dsd
