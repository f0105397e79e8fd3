"""The public SpMM and SDDMM ops with their autograd, the counterpart of
``isplib_tpu.ops.spmm``.

Backward formulas (as in the JAX package):

  sum : grad_x = SpMM(Aᵀ, g)                 grad_v[e] = <g[row e], x[col e]>
  mean: grad_x = SpMM(Aᵀ, g / max(deg,1))    grad_v[e] = <g[row e], x[col e]> / max(deg,1)
  max/min: gradients route through the winning edge of each (row, feature).

A ShardedGraph goes to the sharded path (``dist.spmm_sharded``), with its
own autograd.  On a TiledGraph, sum and mean run the kernels of its plan
version (``kernels/spmm_hybrid``) forward and, for ``grad_x``, over the
transpose plan, or the reference transpose path when the tiling was built
without one (``bwd`` None, as the JAX package falls back to XLA, never to
the forward plan); max and min run the
max/min kernel (K3) over the ``fwd_mm`` plan, which also returns the
winning edge ids.  A plain CSRGraph runs the reference path on any device,
as the JAX package runs XLA there.  ``grad_v`` of sum/mean (an SDDMM) runs
the SDDMM kernel (K4) over the ``fwd_mm`` work list on a TiledGraph and the
plain formula on a CSRGraph; it is computed only when the edge values
require a gradient.  Pad edges never get a gradient.

``sddmm(graph, a, b)`` is the per-edge ``<a[row e], b[col e]>``: K4 forward
on a TiledGraph, the plain formula on a CSRGraph; its backward is the two
plain SpMMs with the cotangent as edge values, as the JAX package spells
them outside any kernel.
"""

from __future__ import annotations

import torch

from ..kernels import sddmm as k4
from ..kernels import spmm_hybrid, spmm_minmax_v4
from ..sparse.tiling import TiledGraph, base_graph
from . import reference
from .semiring import Reduce

__all__ = ["SpMM", "spmm", "SDDMM", "sddmm"]

_BACKENDS = ("auto", "reference")


class SpMM(torch.autograd.Function):
    """``out = reduce(A ⊙ x)``, differentiable in ``x`` and ``value``.

    ``value`` is the graph's edge-value vector (CSR order, padded).  With
    ``backend="auto"`` a TiledGraph runs its plan's sum kernels for sum/mean
    and the max/min kernel for max/min, and a CSRGraph runs the reference
    path; ``"reference"`` always runs the reference path.
    The sum kernels read the values baked into the plan; the max/min
    kernel reads ``value``.
    """

    @staticmethod
    def forward(ctx, graph, reduce: Reduce, backend: str, x: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        base = base_graph(graph)
        tiled = backend == "auto" and isinstance(graph, TiledGraph)
        arg = None
        if reduce in (Reduce.MAX, Reduce.MIN):
            if tiled:
                out, arg = spmm_minmax_v4.spmm_minmax_v4(
                    graph.fwd_mm, base.col, value.contiguous(),
                    x.contiguous(), reduce, base.nnz_padded - 1)
            else:
                out, arg = reference.spmm_arg_raw(
                    base.row, base.col, value, base.deg, x, base.num_rows,
                    reduce)
        elif tiled:
            out = spmm_hybrid.spmm_forward(graph, x, reduce)
        else:
            out = reference.spmm_raw(base.row, base.col, value, base.deg, x,
                                     base.num_rows, reduce)
        ctx.graph, ctx.reduce, ctx.tiled = graph, reduce, tiled
        ctx.save_for_backward(x, value, arg)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, value, arg = ctx.saved_tensors
        base = base_graph(ctx.graph)
        need_x, need_v = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        grad_x = grad_v = None
        if ctx.reduce in (Reduce.SUM, Reduce.MEAN):
            g_eff = g
            if ctx.reduce is Reduce.MEAN:
                g_eff = g / base.deg.clamp(min=1.0).to(g.dtype)[:, None]
            if need_x and ctx.tiled and ctx.graph.bwd is not None:
                grad_x = spmm_hybrid.spmm_transpose_sum(ctx.graph, g_eff)
            elif need_x:
                grad_x = reference.spmm_raw(
                    base.csc_row, base.csc_col,
                    value.index_select(0, base.csc2csr), base.deg_t, g_eff,
                    base.num_cols, Reduce.SUM)
            if need_v and ctx.tiled:
                grad_v = k4.sddmm(ctx.graph.fwd_mm, base.col,
                                  g_eff.contiguous(), x.contiguous())
            elif need_v:
                grad_v = reference.sddmm_dot_raw(base.row, base.col, g_eff, x)
        else:
            # The cotangent routes through the winning edge of each (row,
            # feature): a scatter in plain PyTorch, as the JAX package
            # computes this step with XLA scatters outside any Pallas kernel.
            # Flat indices (col of the winner) * K + feature address the
            # (C + 1, K) gradient, whose last row takes the empty rows'
            # sentinel (a pad edge of column C).
            k = x.shape[1]
            arg = arg.long().reshape(-1)
            flat = (base.col.long()[arg].view(-1, k) * k
                    + torch.arange(k, device=x.device)).reshape(-1)
            g_flat = g.reshape(-1)
            if need_x:
                grad_x = x.new_zeros((base.num_cols + 1) * k).index_add_(
                    0, flat, value.to(g.dtype)[arg] * g_flat)
                grad_x = grad_x.view(base.num_cols + 1, k)[: base.num_cols]
            if need_v:
                x_pad = torch.cat([x, x.new_zeros(1, k)]).reshape(-1)
                grad_v = value.new_zeros(base.nnz_padded, dtype=g.dtype)
                grad_v.index_add_(0, arg, x_pad[flat] * g_flat)
        if grad_v is not None:
            grad_v = grad_v.to(value.dtype)
            grad_v[base.nnz:] = 0  # pad edges, incl. the arg sentinel
        return None, None, None, grad_x, grad_v


def spmm(graph, x: torch.Tensor, reduce: str | Reduce = "sum",
         backend: str = "auto") -> torch.Tensor:
    """Sparse-dense matmul ``out = reduce(A ⊙ x)`` with full autograd.

    Args:
      graph: CSRGraph, TiledGraph (R × C) or ShardedGraph (R × R), which
        runs ``dist.spmm_sharded`` on the process-default mesh.
      x: dense operand (C, K).
      reduce: sum | mean | max | min.
      backend: ``"auto"`` (the kernels for a TiledGraph or a ShardedGraph
        with plans) or ``"reference"`` (the plain PyTorch path for any
        graph; a ShardedGraph's reference route).
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    from ..dist.partition import ShardedGraph
    if isinstance(graph, ShardedGraph):
        from ..dist.spmm_dist import spmm_sharded
        if backend == "reference":
            graph = graph.without_plans()
        return spmm_sharded(graph, x, reduce)
    return SpMM.apply(graph, Reduce.of(reduce), backend, x,
                      base_graph(graph).value)


class SDDMM(torch.autograd.Function):
    """``out[e] = <a[row e], b[col e]>`` (nnz_padded,), pads 0,
    differentiable in ``a`` and ``b``."""

    @staticmethod
    def forward(ctx, graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        base = base_graph(graph)
        if isinstance(graph, TiledGraph):
            out = k4.sddmm(graph.fwd_mm, base.col, a.contiguous(),
                           b.contiguous())
        else:
            out = reference.sddmm_dot_raw(base.row, base.col, a, b)
        ctx.graph = graph
        ctx.save_for_backward(a, b)
        return out

    @staticmethod
    def backward(ctx, gbar: torch.Tensor):
        a, b = ctx.saved_tensors
        base = base_graph(ctx.graph)
        gbar = gbar.clone()
        gbar[base.nnz:] = 0
        grad_a = grad_b = None
        if ctx.needs_input_grad[1]:
            grad_a = reference.spmm_raw(base.row, base.col, gbar, base.deg, b,
                                        base.num_rows, Reduce.SUM)
        if ctx.needs_input_grad[2]:
            grad_b = reference.spmm_raw(
                base.csc_row, base.csc_col, gbar.index_select(0, base.csc2csr),
                base.deg_t, a, base.num_cols, Reduce.SUM)
        return None, grad_a, grad_b


def sddmm(graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge ``<a[row[e]], b[col[e]]>``.

    Returns a (nnz_padded,) vector in CSR edge order (pad entries 0);
    combine with ``graph.with_value`` for attention-style edge weights.
    a: (R, K), b: (C, K).  A TiledGraph runs the SDDMM kernel (K4).
    """
    return SDDMM.apply(graph, a, b)
