"""GAT's attention aggregation, the port's op for edge weights that are
learned: each row's softmax over its entries of LeakyReLU(s_dst[r] +
s_src[c]), head by head, and the weighted sum of x over them (PyG
``GATConv``: each duplicate edge an entry of its own, the graph's self
loops replaced by one a node).

``attention(graph, x, s_src, s_dst)``: x (N, H·C) laid out head by head,
the scores (N, H) (``GATConv`` computes them from x by one product each).
It runs as an aggregation of ``ops.spmm.SpMM`` (a sum whose edge weights
the op computes from the scores), so it shares that op's autograd ranges
and its backend rule.  Under ``backend="auto"`` a TiledGraph runs
``kernels/gat_attention`` over its ``fwd_mm`` and ``bwd_mm`` segment
lists, forward and backward; a CSRGraph, or ``backend="reference"``,
runs the plain formulas of ``ops/reference.py`` over the entries.

Forward keeps each row's ``lse`` (N, H) and the output; backward
recomputes α from them:

  ∂x[c]   = Σ_{entries (r, c)} α g[r]                   (the transposed sum)
  ∂z      = α (⟨g[r], x[c]⟩ − ⟨g[r], out[r]⟩) · LeakyReLU'(z)
  ∂s_dst  = Σ over a row of ∂z,  ∂s_src = Σ over a column of ∂z

A head of C features that is not a multiple of 4 reaches the kernels in a
copy padded to one (layer 3 of the published GAT has 41 a head), made
and undone inside the roles' spans: ``isplib.att.fwd`` (row statistics
and the weighted sum), ``isplib.att.bwd_x`` and ``isplib.att.bwd_e``.
"""

from __future__ import annotations

import torch

from ..kernels import gat_attention as katt
from ..sparse.graph import CSRGraph
from ..sparse.tiling import TiledGraph, auto_tile, base_graph
from ..utils.profiling import span
from . import reference

__all__ = ["attention", "forward", "backward"]


def _pad(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, H·C) as (N, H·Cp), Cp = C rounded up to a multiple of 4, the
    padding zero; t itself (contiguous) when C is one."""
    c = t.shape[1] // heads
    cp = -(-c // 4) * 4
    if cp == c:
        return t.contiguous()
    out = t.new_zeros(t.shape[0], heads, cp)
    out[:, :, :c] = t.view(t.shape[0], heads, c)
    return out.view(t.shape[0], heads * cp)


def _unpad(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    cp = t.shape[1] // heads
    if cp * heads == width:
        return t
    c = width // heads
    return t.view(t.shape[0], heads, cp)[:, :, :c].reshape(t.shape[0], width)


def forward(ctx, graph, backend: str, x: torch.Tensor, s_src: torch.Tensor,
            s_dst: torch.Tensor, slope: float) -> torch.Tensor:
    """SpMM's forward for the attention (``ctx`` is SpMM's)."""
    base = base_graph(graph)
    tiled = backend == "auto" and isinstance(graph, TiledGraph)
    heads, width = s_src.shape[1], x.shape[1]
    if width % heads:
        raise ValueError(f"x's {width} columns are not {heads} heads")
    s_src, s_dst = s_src.contiguous(), s_dst.contiguous()
    with span("isplib.att.fwd"):
        if tiled:
            xp = _pad(x, heads)
            out_p, lse = katt.forward(graph.fwd_mm, base.col, xp, s_src,
                                      s_dst, slope)
            out = _unpad(out_p, heads, width)
            ctx.save_for_backward(xp, s_src, s_dst, lse, out_p)
        else:
            x = x.contiguous()
            dst, src = reference.attention_edges(base.row, base.col,
                                                 base.nnz, base.num_rows)
            out, lse = reference.attention_raw(dst, src, x, s_src, s_dst,
                                               base.num_rows, slope)
            ctx.save_for_backward(x, s_src, s_dst, lse, out)
    ctx.graph, ctx.tiled, ctx.slope, ctx.width = graph, tiled, slope, width
    return out


def backward(ctx, g: torch.Tensor):
    """The cotangents of x, s_src and s_dst."""
    x, s_src, s_dst, lse, out = ctx.saved_tensors
    base = base_graph(ctx.graph)
    heads, slope = s_src.shape[1], ctx.slope
    if not ctx.tiled:
        dst, src = reference.attention_edges(base.row, base.col, base.nnz,
                                             base.num_rows)
        return reference.attention_backward_raw(
            dst, src, x, s_src, s_dst, lse, out, g.contiguous(),
            base.num_rows, slope)
    with span("isplib.att.bwd_x"):
        gp = _pad(g, heads)
        dx = _unpad(katt.backward_x(ctx.graph.bwd_mm, base.csc_col, gp,
                                    s_src, s_dst, lse, slope),
                    heads, ctx.width)
    with span("isplib.att.bwd_e"):
        ds_src, ds_dst = katt.backward_e(
            ctx.graph.fwd_mm, base.col, ctx.graph.bwd_mm, base.csc2csr, gp,
            out, x, s_src, s_dst, lse, slope)
    return dx, ds_src, ds_dst


def attention(graph, x: torch.Tensor, s_src: torch.Tensor,
              s_dst: torch.Tensor, negative_slope: float = 0.2,
              backend: str | None = None) -> torch.Tensor:
    """GAT's aggregation ``out[r] = Σ softmax(LeakyReLU(s_dst[r] + s_src[c]))
    x[c]`` per head over the entries of row r and its self loop, with full
    autograd in x and the scores.

    Args:
      graph: a square CSRGraph or TiledGraph.
      x: (N, H·C), head h in columns [h·C, (h + 1)·C).
      s_src, s_dst: (N, H).
      backend: as ``ops.spmm.spmm`` takes it: under ``"auto"`` a CSRGraph
        goes through ``auto_tile`` at x's width first, whatever its values
        (the attention never reads them).
    """
    from .spmm import SpMM, _check_backend, _default_backend
    from .semiring import Reduce
    if backend is None:
        backend = _default_backend
    _check_backend(backend)
    if graph.num_rows != graph.num_cols:
        raise ValueError("the attention needs a square graph")
    if backend == "auto" and isinstance(graph, CSRGraph):
        graph = auto_tile(graph, k=int(x.shape[1]))
    return SpMM.apply(graph, Reduce.SUM, backend, x, base_graph(graph).value,
                      s_src, s_dst, negative_slope)
