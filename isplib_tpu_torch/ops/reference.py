"""Plain PyTorch SpMM / SDDMM / FusedMM: the port's oracle and small-graph
path.

Counterpart of ``isplib_tpu.ops.xla_backend`` and of the XLA formulation of
``isplib_tpu.ops.fused`` (``_vop``, ``_rop``, ``_edge_scalars``,
``_fused_mm_xla``), written with ``index_select``, ``index_add`` and
``scatter_reduce`` on the padded COO arrays of a
:class:`~isplib_tpu_torch.sparse.graph.CSRGraph`:

  out[r] = reduce_{e : row[e]==r} value[e] * x[col[e]]        (sum/max/min)
  out[r] = (1/max(deg[r],1)) * sum_{e} value[e] * x[col[e]]   (mean)
  fused:   out[r] = aop_{e : row[e]==r} s_e * VOP(x[r], y[col[e]])
           s_e = VSC(SOP(ROP(VOP(x[r], y[col[e]]))))

Empty rows give 0 for max/min, with arg ``nnz_padded - 1`` (a pad edge), and
arg ties go to the lowest edge id.  A max/min of zeros is +0.0 whatever
their signs (``scatter_reduce_`` picks either sign of a tied zero).  Pad
edges (row == num_rows, col == num_cols) land in a dump row that is sliced
off and read a phantom zero row of x, so nothing is masked.

Features are independent, so both SpMMs run over chunks of features whose
(nnz_padded, chunk) temporaries stay within ``CHUNK_BYTES``: at K = 602 on
5.7M edges the unchunked arg path would hold about 55 GB at once.  A graph
whose temporaries fit runs in one pass.  Each output element is computed by
the same operations in the same order as without chunks, so the results are
the same bit for bit.  The SDDMM and the fused pipeline's ROP sum over the
features, so there a graph that needs chunks adds the chunks' partial sums.
The fused functions are differentiable by torch autograd.
"""

from __future__ import annotations

import torch

from .semiring import FusedOp, Reduce, ReduceOp, ScaleOp, VectorOp

__all__ = ["spmm_raw", "spmm_arg_raw", "sddmm_dot_raw", "gather_rows",
           "vop_apply", "fused_edge_scalars", "fused_mm_raw", "CHUNK_BYTES"]

CHUNK_BYTES = 2 << 30  # bytes of per-edge temporaries one chunk may take
# temporaries per edge and feature: the gathered x rows and their products
_SUM_EDGE_FEATURE_BYTES = 8
# the arg path's: products, their compared copy, the tie mask and two int64
# id tensors
_ARG_EDGE_FEATURE_BYTES = 32
# the fused pipeline's: the two gathered rows, the VOP vector, its ROP
# product and the contribution (and the SDDMM's two rows and product)
_FUSED_EDGE_FEATURE_BYTES = 20


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of x (N, K); ``idx`` may address row N (phantom zero)."""
    return _pad_row(x).index_select(0, idx)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1, x.shape[1])], dim=0)


def _chunks(nnz_padded: int, k: int, edge_feature_bytes: int) -> list[slice]:
    """Feature slices whose temporaries of ``edge_feature_bytes`` per edge
    and feature stay within ``CHUNK_BYTES`` (at least one feature each)."""
    width = max(1, CHUNK_BYTES // max(nnz_padded * edge_feature_bytes, 1))
    return [slice(k0, min(k0 + width, k)) for k0 in range(0, k, width)]


def _contrib(col, value, x_pad, feats: slice):
    """value[e] * x[col[e], feats] for every (padded) edge e."""
    return value.to(x_pad.dtype)[:, None] * x_pad[:, feats].index_select(
        0, col)


def spmm_raw(
    row: torch.Tensor,
    col: torch.Tensor,
    value: torch.Tensor,
    deg: torch.Tensor,
    x: torch.Tensor,
    num_rows: int,
    reduce: Reduce | str,
    empty_to_zero: bool = True,
) -> torch.Tensor:
    """SpMM forward on raw padded COO arrays (CSR-sorted rows).

    ``empty_to_zero=False`` keeps the ±inf identity of max/min on rows
    without edges, so the sharded path can combine its local and halo
    halves before it zeroes the rows that are empty in the whole graph.
    """
    reduce = Reduce.of(reduce)
    x_pad = _pad_row(x)
    outs = []
    for feats in _chunks(col.shape[0], x.shape[1], _SUM_EDGE_FEATURE_BYTES):
        contrib = _contrib(col, value, x_pad, feats)
        w = contrib.shape[1]
        if reduce in (Reduce.SUM, Reduce.MEAN):
            out = x.new_zeros(num_rows + 1, w).index_add_(0, row, contrib)
        else:
            ident = float("-inf") if reduce is Reduce.MAX else float("inf")
            out = x.new_full((num_rows + 1, w), ident).scatter_reduce_(
                0, row.long()[:, None].expand(-1, w), contrib,
                "amax" if reduce is Reduce.MAX else "amin")
        outs.append(out[:num_rows])
    out = torch.cat(outs, dim=1) if outs else x.new_zeros(num_rows, 0)
    if reduce is Reduce.MEAN:
        out = out / deg.clamp(min=1.0).to(out.dtype)[:, None]
    elif reduce in (Reduce.MAX, Reduce.MIN) and empty_to_zero:
        out = torch.where((deg > 0)[:, None], out + 0.0,
                          torch.zeros_like(out))
    return out


def spmm_arg_raw(
    row: torch.Tensor,
    col: torch.Tensor,
    value: torch.Tensor,
    deg: torch.Tensor,
    x: torch.Tensor,
    num_rows: int,
    reduce: Reduce | str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max/min SpMM plus the winning edge id per (row, feature), int32."""
    reduce = Reduce.of(reduce)
    if reduce not in (Reduce.MAX, Reduce.MIN):
        raise ValueError(f"spmm_arg_raw takes max or min, got {reduce}")
    nnz_padded = col.shape[0]
    x_pad = _pad_row(x)
    eids = torch.arange(nnz_padded, device=x.device)[:, None]
    outs, args = [], []
    for feats in _chunks(nnz_padded, x.shape[1], _ARG_EDGE_FEATURE_BYTES):
        contrib = _contrib(col, value, x_pad, feats)
        w = contrib.shape[1]
        cmp = contrib if reduce is Reduce.MAX else -contrib
        idx = row.long()[:, None].expand(-1, w)
        best = x.new_full((num_rows + 1, w), float("-inf")).scatter_reduce_(
            0, idx, cmp, "amax")
        is_best = cmp == best.index_select(0, row)
        eid = torch.where(is_best, eids, nnz_padded - 1)
        arg = torch.full((num_rows + 1, w), nnz_padded - 1,
                         dtype=torch.int64, device=x.device).scatter_reduce_(
                             0, idx, eid, "amin")
        outs.append((best if reduce is Reduce.MAX else -best)[:num_rows])
        args.append(arg[:num_rows])
    out = torch.cat(outs, dim=1) if outs else x.new_zeros(num_rows, 0)
    arg = (torch.cat(args, dim=1) if args else torch.zeros(
        num_rows, 0, dtype=torch.int64, device=x.device))
    valid = (deg > 0)[:, None]
    out = torch.where(valid, out + 0.0, torch.zeros_like(out))
    arg = torch.where(valid, arg, torch.full_like(arg, nnz_padded - 1))
    return out, arg.to(torch.int32)


def sddmm_dot_raw(
    row: torch.Tensor,
    col: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Per-edge dot product ``out[e] = <a[row[e]], b[col[e]]>``; pad edges
    address the phantom zero rows and give 0."""
    out = a.new_zeros(col.shape[0])
    for feats in _chunks(col.shape[0], a.shape[1], _FUSED_EDGE_FEATURE_BYTES):
        out = out + (gather_rows(a[:, feats], row)
                     * gather_rows(b[:, feats], col)).sum(dim=-1)
    return out


def vop_apply(vop: VectorOp, xv: torch.Tensor,
              yv: torch.Tensor) -> torch.Tensor:
    """The VOP stage on gathered rows; the side it does not read may be
    None."""
    if vop is VectorOp.COPY_RHS:
        return yv
    if vop is VectorOp.COPY_LHS:
        return xv
    if vop is VectorOp.ADD:
        return xv + yv
    if vop is VectorOp.SUB:
        return xv - yv
    if vop is VectorOp.MUL:
        return xv * yv
    if vop is VectorOp.MAX:
        return torch.maximum(xv, yv)
    if vop is VectorOp.MIN:
        return torch.minimum(xv, yv)
    raise ValueError(vop)


def edge_vectors(row, col, x, y, vop: VectorOp, feats: slice):
    """(x[row], y[col], VOP of the two) for the features ``feats`` of every
    edge; a side the VOP does not read is None."""
    xv = (None if vop is VectorOp.COPY_RHS
          else gather_rows(x[:, feats], row))
    yv = (None if vop is VectorOp.COPY_LHS
          else gather_rows(y[:, feats], col))
    return xv, yv, vop_apply(vop, xv, yv)


def rop_sum(rop: ReduceOp, row, col, x, y, vop: VectorOp):
    """The ROP stage, ``t_e`` (E,), summed over feature chunks; None for
    NOOP."""
    if rop is ReduceOp.NOOP:
        return None
    if rop not in (ReduceOp.DOT, ReduceOp.NORM2):
        raise ValueError(rop)
    t = y.new_zeros(col.shape[0])
    for feats in _chunks(col.shape[0], y.shape[1], _FUSED_EDGE_FEATURE_BYTES):
        v = edge_vectors(row, col, x, y, vop, feats)[2]
        t = t + (v if rop is ReduceOp.DOT else v * v).sum(dim=-1)
    return t


def row_degree(deg: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``max(deg[row], 1)`` per edge; the pad row reads 1."""
    return torch.cat([deg.clamp(min=1.0), deg.new_ones(1)]).index_select(
        0, row)


def fused_edge_scalars(row, col, value, deg, x, y,
                       op: FusedOp) -> torch.Tensor:
    """Per-edge scalars ``s_e`` (E,) of the pipeline, on padded or unpadded
    edge arrays; pad edges are not masked.  ROP = NOOP feeds t = 1 into
    the SOP."""
    t = rop_sum(op.rop, row, col, x, y, op.vop)
    if op.sop is not None:
        t = op.sop(t if t is not None else y.new_ones(col.shape[0]))
    s = t if t is not None else y.new_ones(col.shape[0])
    if op.vsc is ScaleOp.MUL:
        s = s * value
    elif op.vsc is ScaleOp.MEAN:
        s = s * value / row_degree(deg, row)
    return s


def fused_mm_raw(row, col, value, deg, x, y, num_rows: int,
                 op: FusedOp) -> torch.Tensor:
    """The whole pipeline: ``out[r] = aop_e s_e * VOP(x[r], y[col e])``,
    (num_rows, K).  Max/min of an empty row give 0."""
    s = fused_edge_scalars(row, col, value, deg, x, y, op)
    outs = []
    for feats in _chunks(col.shape[0], y.shape[1], _FUSED_EDGE_FEATURE_BYTES):
        v = edge_vectors(row, col, x, y, op.vop, feats)[2]
        contrib = s[:, None].to(v.dtype) * v
        zero = contrib.new_zeros(num_rows + 1, contrib.shape[1])
        if op.aop is Reduce.SUM:
            out = zero.index_add(0, row, contrib)
        elif op.aop in (Reduce.MAX, Reduce.MIN):
            out = zero.scatter_reduce(
                0, row.long()[:, None].expand_as(contrib), contrib,
                "amax" if op.aop is Reduce.MAX else "amin",
                include_self=False)
        else:
            raise ValueError(op.aop)
        outs.append(out[:num_rows])
    return torch.cat(outs, dim=1) if outs else y.new_zeros(num_rows, 0)
