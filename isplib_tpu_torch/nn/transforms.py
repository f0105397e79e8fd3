"""Graph transforms run once per graph on the host, the counterpart of
``isplib_tpu.nn.transforms`` (``add_self_loops``, ``gcn_norm``,
``row_normalize``).  The result lives on the input graph's device."""

from __future__ import annotations

import numpy as np

from ..sparse.graph import CSRGraph, from_edge_index
from ..utils.profiling import stage

__all__ = ["add_self_loops", "gcn_norm", "row_normalize"]


def _coo(graph: CSRGraph):
    n = graph.nnz
    with stage("norm.readback", bytes=n * (graph.row.element_size()
                                           + graph.col.element_size()
                                           + graph.value.element_size())):
        return (graph.row[:n].cpu().numpy(), graph.col[:n].cpu().numpy(),
                graph.value[:n].detach().cpu().numpy())


def add_self_loops(graph: CSRGraph, fill_value: float = 1.0,
                   edge_multiple: int = 512) -> CSRGraph:
    """A + fill·I for the nodes without a self loop (square graphs only)."""
    if graph.num_rows != graph.num_cols:
        raise ValueError("add_self_loops needs a square graph")
    row, col, val = _coo(graph)
    has_loop = np.zeros(graph.num_rows, bool)
    has_loop[row[row == col]] = True
    new = np.flatnonzero(~has_loop)
    row = np.concatenate([row, new])
    col = np.concatenate([col, new])
    val = np.concatenate([val, np.full(new.shape, fill_value, np.float32)])
    return from_edge_index(np.stack([col, row]), num_nodes=graph.num_rows,
                           edge_value=val, edge_multiple=edge_multiple,
                           device=graph.device)


def gcn_norm(graph: CSRGraph, add_loops: bool = True,
             edge_multiple: int = 512) -> CSRGraph:
    """Â = D^{-1/2} (A + I) D^{-1/2}, PyG ``gcn_norm`` semantics."""
    with stage("norm.gcn", nnz=graph.nnz):
        if add_loops:
            graph = add_self_loops(graph, 1.0, edge_multiple)
        row, col, val = _coo(graph)
        deg = np.zeros(graph.num_rows, np.float64)
        np.add.at(deg, row, val.astype(np.float64))
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        dinv[deg <= 0] = 0.0
        new_val = (dinv[row] * val * dinv[col]).astype(np.float32)
        return from_edge_index(np.stack([col, row]),
                               num_nodes=graph.num_rows, edge_value=new_val,
                               edge_multiple=edge_multiple,
                               device=graph.device)


def row_normalize(graph: CSRGraph, edge_multiple: int = 512) -> CSRGraph:
    """Â = D^{-1} A (random-walk normalisation)."""
    row, col, val = _coo(graph)
    deg = np.zeros(graph.num_rows, np.float64)
    np.add.at(deg, row, val.astype(np.float64))
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    new_val = (dinv[row] * val).astype(np.float32)
    return from_edge_index(np.stack([col, row]), num_nodes=graph.num_rows,
                           edge_value=new_val, edge_multiple=edge_multiple,
                           device=graph.device)
