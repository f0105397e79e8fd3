"""Plain PyTorch SpMM / SDDMM: the port's oracle and small-graph path.

Counterpart of ``isplib_tpu.ops.xla_backend``, written with ``index_select``,
``index_add_`` and ``scatter_reduce_`` on the padded COO arrays of a
:class:`~isplib_tpu_torch.sparse.graph.CSRGraph`:

  out[r] = reduce_{e : row[e]==r} value[e] * x[col[e]]        (sum/max/min)
  out[r] = (1/max(deg[r],1)) * sum_{e} value[e] * x[col[e]]   (mean)

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
the same bit for bit.
"""

from __future__ import annotations

import torch

from .semiring import Reduce

__all__ = ["spmm_raw", "spmm_arg_raw", "sddmm_dot_raw", "gather_rows",
           "CHUNK_BYTES"]

CHUNK_BYTES = 2 << 30  # bytes of per-edge temporaries one chunk may take
# temporaries per edge and feature: the gathered x rows and their products
_SUM_EDGE_FEATURE_BYTES = 8
# the arg path's: products, their compared copy, the tie mask and two int64
# id tensors
_ARG_EDGE_FEATURE_BYTES = 32


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
) -> torch.Tensor:
    """SpMM forward on raw padded COO arrays (CSR-sorted rows)."""
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
    elif reduce in (Reduce.MAX, Reduce.MIN):
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
    return (gather_rows(a, row) * gather_rows(b, col)).sum(dim=-1)
