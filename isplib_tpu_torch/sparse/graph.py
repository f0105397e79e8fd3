"""Padded CSR graph container, the counterpart of ``isplib_tpu.sparse.graph``.

A :class:`CSRGraph` holds every array the forward and backward passes need,
built once on the host (numpy and the port's native sorter) and then moved
to one device.  The field set, dtypes and padding contract are those of the
JAX package, so the two containers compare field by field:

* pad edges are appended after the real ones with row = ``num_rows``,
  col = ``num_cols`` and value 0, and there is always at least one, so edge id
  ``nnz_padded - 1`` is an inert sentinel;
* indices are int32, ``value`` / ``deg`` / ``deg_t`` float32;
* the CSC view (``csc_*``) is the padded edge list stably sorted by column,
  and ``csc2csr[e]`` is the CSR position of CSC edge ``e``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..utils.profiling import stage

__all__ = ["CSRGraph", "from_edge_index", "from_scipy", "graph_from_arrays"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_ARRAY_FIELDS = ("rowptr", "row", "col", "value", "csc_colptr", "csc_row",
                 "csc_col", "csc_value", "csc2csr", "deg", "deg_t")


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """An immutable padded CSR adjacency with its transpose (CSC) view.

    Entry ``(r, c)`` is an edge from source ``c`` to destination ``r``:
    ``spmm(graph, x)[r] = reduce_{e : row[e]=r} value[e] * x[col[e]]``.
    ``rowptr`` / ``csc_colptr`` cover the real edges only (their last entry
    is ``nnz``); the edge arrays have length ``nnz_padded``.
    """

    rowptr: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    value: torch.Tensor
    csc_colptr: torch.Tensor
    csc_row: torch.Tensor
    csc_col: torch.Tensor
    csc_value: torch.Tensor
    csc2csr: torch.Tensor
    deg: torch.Tensor
    deg_t: torch.Tensor
    num_rows: int
    num_cols: int
    nnz: int

    @property
    def nnz_padded(self) -> int:
        return int(self.col.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @property
    def device(self) -> torch.device:
        return self.col.device

    def to(self, device: str | torch.device) -> "CSRGraph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in _ARRAY_FIELDS})

    def transpose(self) -> "CSRGraph":
        """The transpose graph as a first-class CSRGraph (shares buffers)."""
        return CSRGraph(
            rowptr=self.csc_colptr,
            row=self.csc_row,
            col=self.csc_col,
            value=self.csc_value,
            csc_colptr=self.rowptr,
            csc_row=self.row,
            csc_col=self.col,
            csc_value=self.value,
            csc2csr=torch.argsort(self.csc2csr).to(torch.int32),
            deg=self.deg_t,
            deg_t=self.deg,
            num_rows=self.num_cols,
            num_cols=self.num_rows,
            nnz=self.nnz,
        )

    def with_value(self, value: torch.Tensor) -> "CSRGraph":
        """Replace edge values (CSR order, length nnz or nnz_padded).

        The CSC view is permuted through ``csc2csr`` so both stay consistent;
        a value that requires grad keeps its autograd history.
        """
        value = value.to(device=self.device, dtype=torch.float32)
        if value.shape[0] == self.nnz:
            value = torch.cat([value, value.new_zeros(
                self.nnz_padded - self.nnz)])
        return dataclasses.replace(
            self, value=value, csc_value=value[self.csc2csr.long()])


# ---------------------------------------------------------------------------
# Host-side construction (numpy, once per graph)
# ---------------------------------------------------------------------------

def _build_arrays(
    row: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows: int,
    num_cols: int,
    edge_multiple: int,
) -> dict[str, Any]:
    """Padded CSR + CSC numpy arrays of a COO edge list.

    Same arrays as ``isplib_tpu.sparse.graph._build_arrays``.  Both orders
    are stable sorts: the port's native counting sort
    (``native.sort_csr``), or ``np.lexsort`` where ``native.available`` is
    patched to False (the reference build); the two give equal arrays.
    """
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    nnz = int(row.shape[0])
    if value is None:
        value = np.ones(nnz, dtype=np.float32)
    else:
        value = np.asarray(value, dtype=np.float32)

    if nnz:
        with stage("graph.sort", order="csr", nnz=nnz):
            if native.available():
                perm = native.sort_csr(row, col, num_rows, num_cols)[0]
            else:
                perm = np.lexsort((col, row))  # CSR order: last key first
        row, col, value = row[perm], col[perm], value[perm]

    # at least one pad edge: edge id nnz_padded-1 is the inert sentinel
    padded = _round_up(nnz + 1, edge_multiple)
    pad = padded - nnz
    row_p = np.concatenate([row, np.full(pad, num_rows, dtype=np.int64)])
    col_p = np.concatenate([col, np.full(pad, num_cols, dtype=np.int64)])
    val_p = np.concatenate([value, np.zeros(pad, dtype=np.float32)])

    rowptr = np.zeros(num_rows + 1, dtype=np.int64)
    counts = np.bincount(row, minlength=num_rows)
    rowptr[1:] = np.cumsum(counts)

    # stable sort by column keeps pad edges (col == num_cols) at the end
    with stage("graph.sort", order="csc", nnz=nnz):
        if native.available():
            csc_perm = native.sort_csr(col_p, row_p, num_cols + 1,
                                       num_rows + 1)[0]
        else:
            csc_perm = np.lexsort((row_p, col_p))
    col_counts = (np.bincount(col, minlength=num_cols) if nnz
                  else np.zeros(num_cols, dtype=np.int64))
    csc_colptr = np.zeros(num_cols + 1, dtype=np.int64)
    csc_colptr[1:] = np.cumsum(col_counts)

    return dict(
        rowptr=rowptr.astype(np.int32),
        row=row_p.astype(np.int32),
        col=col_p.astype(np.int32),
        value=val_p,
        csc_colptr=csc_colptr.astype(np.int32),
        csc_row=col_p[csc_perm].astype(np.int32),   # transpose: row' = col
        csc_col=row_p[csc_perm].astype(np.int32),   # transpose: col' = row
        csc_value=val_p[csc_perm],
        csc2csr=csc_perm.astype(np.int32),
        deg=counts.astype(np.float32),
        deg_t=col_counts.astype(np.float32),
        num_rows=int(num_rows),
        num_cols=int(num_cols),
        nnz=nnz,
    )


def graph_from_arrays(arrays: dict,
                      device: str | torch.device = "cuda") -> CSRGraph:
    """CSRGraph on ``device`` from a ``_build_arrays`` dict (extra keys,
    e.g. a dataset's features, are ignored)."""
    dev = resolve_device(device)
    host = {f: np.ascontiguousarray(arrays[f]) for f in _ARRAY_FIELDS}
    with stage("graph.upload", bytes=sum(a.nbytes for a in host.values())):
        fields = {f: torch.from_numpy(a).to(dev) for f, a in host.items()}
    return CSRGraph(**fields, num_rows=int(arrays["num_rows"]),
                    num_cols=int(arrays["num_cols"]), nnz=int(arrays["nnz"]))


def from_edge_index(
    edge_index: np.ndarray,
    num_nodes: Optional[int] = None,
    num_src_nodes: Optional[int] = None,
    edge_value: Optional[np.ndarray] = None,
    edge_multiple: int = 512,
    device: str | torch.device = "cuda",
    tiling: Optional[dict] = None,
):
    """Build a CSRGraph from a (2, E) COO ``[src; dst]`` edge_index.

    Edge (src, dst) becomes entry (row=dst, col=src), the message-passing
    adjacency of PyG's ``ToSparseTensor``.  With ``tiling`` (a dict of
    ``build_tiling`` keys, e.g. ``dict(version=2, k=41)``) the result is a
    TiledGraph whose plans are built from the host arrays, with no read
    back from the device.
    """
    edge_index = np.asarray(edge_index)
    col, row = edge_index[0], edge_index[1]
    if num_nodes is None:
        num_nodes = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
    num_cols = num_src_nodes if num_src_nodes is not None else num_nodes
    with stage("graph.build", nnz=int(row.shape[0]), rows=int(num_nodes),
               cols=int(num_cols)):
        arrays = _build_arrays(row, col, edge_value, num_nodes, num_cols,
                               edge_multiple)
        return _finalize(arrays, device, tiling)


def from_scipy(mat, edge_multiple: int = 512,
               device: str | torch.device = "cuda",
               tiling: Optional[dict] = None):
    """Build from any scipy.sparse matrix (e.g. loaded from a .mtx file);
    ``tiling`` as in :func:`from_edge_index`."""
    coo = mat.tocoo()
    with stage("graph.build", nnz=int(coo.nnz), rows=int(coo.shape[0]),
               cols=int(coo.shape[1])):
        arrays = _build_arrays(coo.row, coo.col, coo.data.astype(np.float32),
                               int(coo.shape[0]), int(coo.shape[1]),
                               edge_multiple)
        return _finalize(arrays, device, tiling)


def _finalize(arrays: dict, device, tiling: Optional[dict]):
    graph = graph_from_arrays(arrays, device)
    if tiling is None:
        return graph
    if not isinstance(tiling, dict):
        raise TypeError(f"tiling must be None or a dict of build_tiling "
                        f"keys, got {type(tiling).__name__}")
    from .tiling import build_tiling_from_numpy  # tiling imports this module
    return build_tiling_from_numpy(graph, arrays, **tiling)
