"""The generalized FusedMM pipeline, the counterpart of
``isplib_tpu.ops.fused``:

    v_e = VOP(x[row_e], y[col_e])          per-edge vector
    t_e = ROP(v_e)                         per-edge scalar (dot, norm², or 1)
    s_e = SOP(t_e)                         scalar op (ScalarOp catalogue)
    w_e = VSC(s_e, value_e, deg_row)       scale (× value, ÷ degree)
    z_r = AOP_e { w_e · v_e }              accumulate (sum / max / min)

Routes (``backend="auto"``), decided by the graph and the op alone:

* AOP = SUM on a :class:`TiledGraph`, ``K <= 256``, ``sop`` None or a
  :class:`ScalarOp`: the :class:`FusedMM` autograd Function, forward by the
  FusedMM kernel (K5) and ``grad_x`` / ``grad_y`` by its two backward passes
  (K6) over the CSR and CSC work lists.
* AOP = MAX / MIN with the COPY_RHS message on a TiledGraph: the per-edge
  scalars ``s`` from :func:`fused_mm_edges` (differentiable), then the
  max/min SpMM kernel (K3) with ``s`` as the edge values, whose backward
  routes through the winning edges (the JAX package's
  ``_fused_minmax_kernel``; K3 reads the values it is given, so the JAX
  package's ``replace_plan_values`` is passing ``s``).
* Everything else runs the plain, differentiable formulation
  (``ops/reference.py``): a CSRGraph, ``backend="reference"`` (the JAX
  package's ``backend="xla"``), K > 256, any other SOP callable, and a graph
  whose edge values require a gradient (the kernels give no value
  cotangent; the JAX package routes that case the same way).

Under ``ScaleOp.NONE`` a real edge of value 0 counts on every route, as on
the JAX package's XLA path (its Pallas path drops such edges).
``fused_mm_edges`` returns the per-edge scalars before accumulation (a
generalized SDDMM).
"""

from __future__ import annotations

import torch

from ..kernels import fused as k5
from ..kernels import fused_bwd as k6
from ..sparse.tiling import TiledGraph, base_graph
from . import reference
from .semiring import FusedOp, Reduce, ScalarOp, ScaleOp, VectorOp
from .spmm import _BACKENDS, SpMM

__all__ = ["FusedMM", "fused_mm", "fused_mm_edges"]


class FusedMM(torch.autograd.Function):
    """Sum-accumulated pipeline on a TiledGraph through K5 forward and K6
    backward, differentiable in ``x`` and ``y``."""

    @staticmethod
    def forward(ctx, graph: TiledGraph, op: FusedOp, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        base = graph.graph
        x, y = x.contiguous(), y.contiguous()
        out = k5.fused(graph.fwd_mm, base.col, base.value, base.deg, x, y,
                       op)
        ctx.graph, ctx.op = graph, op
        ctx.save_for_backward(x, y)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, y = ctx.saved_tensors
        graph, op = ctx.graph, ctx.op
        base = graph.graph
        if op.vsc is ScaleOp.MEAN:  # the row scale folds into g
            g = g / base.deg.clamp(min=1.0)[:, None]
        g = g.contiguous()
        grad_x = grad_y = None
        if ctx.needs_input_grad[2]:
            grad_x = (torch.zeros_like(x) if op.vop is VectorOp.COPY_RHS
                      else k6.fused_bwd(graph.fwd_mm, base.col, base.value,
                                        x, y, g, op, pass_b=False))
        if ctx.needs_input_grad[3]:
            grad_y = k6.fused_bwd(graph.bwd_mm, base.csc_col, base.csc_value,
                                  x, y, g, op, pass_b=True)
        return None, None, grad_x, grad_y


def fused_mm_edges(graph, x: torch.Tensor, y: torch.Tensor,
                   op: FusedOp) -> torch.Tensor:
    """Per-edge scalars ``s_e`` of the pipeline, (nnz_padded,) in CSR edge
    order with pads 0, differentiable."""
    base = base_graph(graph)
    s = reference.fused_edge_scalars(base.row, base.col, base.value,
                                     base.deg, x, y, op)
    real = torch.arange(base.nnz_padded, device=s.device) < base.nnz
    return torch.where(real, s, 0.0)


def fused_mm(graph, x: torch.Tensor, y: torch.Tensor, op: FusedOp,
             backend: str = "auto") -> torch.Tensor:
    """The full pipeline: accumulate ``s_e · v_e`` into the output rows.

    Args:
      graph: CSRGraph or TiledGraph (R × C).
      x: (R, K) destination-side features; y: (C, K) source-side features.
      op: the pipeline.
      backend: ``"auto"`` (the kernels where the module docstring says) or
        ``"reference"`` (the plain formulation for any graph).
    Returns (R, K).
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    base = base_graph(graph)
    if (backend == "auto" and isinstance(graph, TiledGraph)
            and not base.value.requires_grad):
        aop = Reduce.of(op.aop)
        if (aop is Reduce.SUM and y.shape[-1] <= k5.MAX_K
                and (op.sop is None or isinstance(op.sop, ScalarOp))):
            return FusedMM.apply(graph, op, x, y)
        if aop in (Reduce.MAX, Reduce.MIN) and op.vop is VectorOp.COPY_RHS:
            return SpMM.apply(graph, aop, "auto", y,
                              fused_mm_edges(graph, x, y, op))
    return reference.fused_mm_raw(base.row, base.col, base.value, base.deg,
                                  x, y, base.num_rows, op)
