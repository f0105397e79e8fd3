"""One GraphSAGE-max training epoch, counted from the configuration's
equations (see ``reference/sage_max.py``) and the graph.

A = the graph as given, one entry an edge.  The first layer aggregates the
input features (K = features); nothing flows back into them, so its
aggregation has no backward.  The second aggregates the hidden layer, and
its gradient is routed to the winners.  A dense product counts 2·m·k·n in
the forward pass and for each gradient training needs; a max counts one
comparison an entry and feature; the routing one add a (row, feature).
"""

from __future__ import annotations


def aggregations(cfg: dict, graph: dict) -> list[dict]:
    n, f, h = graph["nodes"], graph["features"], cfg["hidden"]
    nnz = graph["edges"]
    return [dict(name="A.layer1", kind="max", rows=n, cols=n, nnz=nnz, k=f),
            dict(name="A.layer2", kind="max", rows=n, cols=n, nnz=nnz, k=h),
            dict(name="route.layer2", kind="route", rows=n, cols=n, nnz=0,
                 k=h)]


def _agg_ops(a: dict) -> int:
    return a["rows"] * a["k"] if a["kind"] == "route" else a["nnz"] * a["k"]


def model_flops(cfg: dict, graph: dict) -> int:
    n, f = graph["nodes"], graph["features"]
    h, c = cfg["hidden"], graph["classes"]
    dense = (2 * n * f * h * 4      # agg Wl1, x Wr1, and both gradients
             + 2 * n * h * c * 6)   # agg Wl2, h Wr2, both weight gradients,
    #                                 and the gradients of agg and h
    return dense + sum(_agg_ops(a) for a in aggregations(cfg, graph))
