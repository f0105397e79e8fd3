"""Backward of the sum-accumulated FusedMM pipeline: ``csrc/fused_bwd.cu``
and its plain version.

Counterpart of ``isplib_tpu/kernels/fused_pallas_bwd.py::_fused_bwd_kernel``
(K6).  Given the output cotangent ``g`` (R, K) (for VSC_MEAN already divided
by ``max(deg, 1)``, so MEAN scales like MUL here), pass A walks the CSR
(``fwd_mm``) and returns ``grad_x`` (R, K); pass B walks the CSC
(``bwd_mm``, the rows of Aᵀ) and returns ``grad_y`` (C, K).  Each edge
recomputes the stages and applies the chain rule:

    v = VOP(x_i, y_j);  t = ROP(v);  s = SOP(t)·w          (w = value or 1)
    a = <g_i, v>;  ŝ = a·w·SOP'(t)  (0 for ROP = NOOP)
    ĝv = s·g_i + ŝ (DOT) or + 2ŝ·v (NORM2)
    grad_x_i += dVOP/dx · ĝv;   grad_y_j += dVOP/dy · ĝv

A tie of VOP max/min splits the cotangent 0.5 / 0.5, as torch autograd of
the plain formulation and the JAX package's XLA path do.  There is no value
cotangent.  The kernel is fp32; its plain version computes the per-edge
terms in the operands' type and their sums over edges in float64.  For a CUDA
tensor the wrapper launches the kernel or raises; the plain version runs
only for a CPU tensor (and in ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import reference
from ..ops.reference import _FUSED_EDGE_FEATURE_BYTES, _chunks
from ..ops.semiring import FusedOp, ReduceOp, ScaleOp, VectorOp
from ..sparse.tiling_v4mm import MinMaxPlan
from . import build
from .fused import check_operands, pad4, stage_codes, unpad

__all__ = ["fused_bwd", "fused_bwd_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches (one per pass) since the count was set to 0


def _vop_grad(vop: VectorOp, xv, yv, wrt_y: bool):
    """d VOP / dx (or dy) on gathered rows: a tensor, or a number."""
    if vop is VectorOp.MUL:
        return xv if wrt_y else yv
    if vop in (VectorOp.MAX, VectorOp.MIN):
        a, b = (yv, xv) if wrt_y else (xv, yv)
        win = a > b if vop is VectorOp.MAX else a < b
        return torch.where(win, 1.0, torch.where(a == b, 0.5, 0.0))
    if vop is VectorOp.COPY_RHS:
        return 1.0 if wrt_y else 0.0
    if vop is VectorOp.COPY_LHS:
        return 0.0 if wrt_y else 1.0
    if vop is VectorOp.SUB:
        return -1.0 if wrt_y else 1.0
    return 1.0  # ADD


def fused_bwd_plain(plan: MinMaxPlan, col: torch.Tensor,
                    value: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor, op: FusedOp,
                    pass_b: bool) -> torch.Tensor:
    """The same pass in plain PyTorch, the chain rule written out over the
    plan's edges (over feature chunks, as the reference path runs).  The
    per-edge terms are in the operands' type; their sum over a row's edges
    is taken in float64, so this oracle stays exact to the output's
    rounding where an R-MAT hub row adds 10⁵ terms that cancel (an fp32
    ``index_add`` there strays by up to ~1e-4 of the output's scale)."""
    n, k = plan.nnz, y.shape[1]
    own = plan.edge_rows()
    other = col[:n].long()
    i, j = (other, own) if pass_b else (own, other)
    w = (y.new_ones(n) if ScaleOp(op.vsc) is ScaleOp.NONE else value[:n])
    rop = ReduceOp(op.rop)
    feats = _chunks(n, k, _FUSED_EDGE_FEATURE_BYTES)
    shat = None
    if rop is ReduceOp.NOOP:
        s = op.sop(y.new_ones(n)) if op.sop is not None else y.new_ones(n)
    else:
        t = reference.rop_sum(rop, i, j, x, y, op.vop)
        a = y.new_zeros(n)
        for f in feats:
            v = reference.edge_vectors(i, j, x, y, op.vop, f)[2]
            a = a + (g[:, f].index_select(0, i) * v).sum(dim=-1)
        s = op.sop(t) if op.sop is not None else t
        ds = op.sop.grad(t) if op.sop is not None else 1.0
        shat = a * w * ds
    s = s * w
    out = y.new_zeros(plan.num_rows, k, dtype=torch.float64)
    for f in feats:
        xv = x[:, f].index_select(0, i)
        yv = y[:, f].index_select(0, j)
        v = reference.vop_apply(op.vop, xv, yv)
        d = s[:, None] * g[:, f].index_select(0, i)
        if rop is ReduceOp.DOT:
            d = d + shat[:, None]
        elif rop is ReduceOp.NORM2:
            d = d + 2.0 * shat[:, None] * v
        out[:, f] = out[:, f].index_add(
            0, own, (_vop_grad(op.vop, xv, yv, pass_b) * d).double())
    return out.to(y.dtype)


@functools.cache
def _lib():
    fn = build.load("fused_bwd").fused_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bwd(plan: MinMaxPlan, col: torch.Tensor, value: torch.Tensor,
              x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
              op: FusedOp, pass_b: bool) -> torch.Tensor:
    """One backward pass of the pipeline ``op`` (AOP = SUM).

    Pass A (``pass_b=False``): ``plan`` is ``fwd_mm`` and (``col``,
    ``value``) the graph's CSR edges; returns grad_x (R, K).  Pass B:
    ``plan`` is ``bwd_mm`` and (``col``, ``value``) the CSC's
    (``csc_col``, ``csc_value``); returns grad_y (C, K).  x (R, K), y (C, K)
    and g (R, K) float32."""
    global LAUNCHES
    codes = stage_codes(op)
    rows_x, rows_y = ((plan.num_cols, plan.num_rows) if pass_b
                      else (plan.num_rows, plan.num_cols))
    check_operands(plan, col, value, {"x": (x, rows_x), "y": (y, rows_y),
                                      "g": (g, rows_x)})
    if x.device.type == "cpu":
        return fused_bwd_plain(plan, col, value, x, y, g, op, pass_b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bwd runs on cuda or cpu, not {x.device}")
    k = x.shape[1]
    x, y, g = pad4(x), pad4(y), pad4(g)
    out = torch.empty(plan.num_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out[:, :k]
    err = _lib()(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
                 plan.seg_slot.data_ptr(), plan.split_rows.data_ptr(),
                 col.data_ptr(), value.data_ptr(), x.data_ptr(),
                 y.data_ptr(), g.data_ptr(), out.data_ptr(), plan.nseg,
                 plan.nsplit, x.shape[1], *codes, int(pass_b),
                 x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_bwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return unpad(out, k)
