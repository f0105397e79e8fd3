"""One GCN training epoch, counted from the configuration's equations (see
``reference/gcn.py``) and the graph: its aggregations and its operations.

Â has one entry an edge and a self loop a node (the graph's law has no
self loops).  A dense product (m × k) · (k × n) counts 2·m·k·n, in the
forward pass and for each gradient that training needs (none for the
input features); a sum aggregation 2·nnz·K; elementwise work and Adam
are not counted.
"""

from __future__ import annotations


def _nnz(graph: dict) -> int:
    if graph["law"]["self_loops"]:
        raise ValueError("gcn's count assumes a graph without self loops")
    return graph["edges"] + graph["nodes"]


def aggregations(cfg: dict, graph: dict) -> list[dict]:
    """Forward Â at K = hidden and classes, backward Âᵀ at classes and
    hidden."""
    n, h, c = graph["nodes"], cfg["hidden"], graph["classes"]
    nnz = _nnz(graph)
    return [dict(name=name, kind="sum", rows=n, cols=n, nnz=nnz, k=k)
            for name, k in (("A.layer1", h), ("A.layer2", c),
                            ("At.layer2", c), ("At.layer1", h))]


def model_flops(cfg: dict, graph: dict) -> int:
    n, f = graph["nodes"], graph["features"]
    h, c = cfg["hidden"], graph["classes"]
    dense = (2 * n * f * h * 2      # x W1, and W1's gradient
             + 2 * n * h * c * 3)   # h W2, W2's gradient, h's gradient
    return dense + sum(2 * a["nnz"] * a["k"]
                       for a in aggregations(cfg, graph))
