"""One GraphSAGE-mean training epoch, counted from the configuration's
equations (see ``reference/sage_mean.py``) and the graph.

A = the graph as given, one entry an edge.  The first layer sums the input
features over A (K = features); nothing flows back into them, so its
aggregation has no backward.  The second sums the hidden layer, and its
gradient is a sum over Aᵀ at the same width.  Each sum counts 2·nnz·K;
the division by the degree, like all elementwise work and Adam, is not
counted.  A dense product counts 2·m·k·n in the forward pass and for each
gradient training needs.  Layer 1 is counted in every epoch, as the port
computes it.
"""

from __future__ import annotations


def aggregations(cfg: dict, graph: dict) -> list[dict]:
    n, f, h = graph["nodes"], graph["features"], cfg["hidden"]
    nnz = graph["edges"]
    return [dict(name=name, kind="sum", rows=n, cols=n, nnz=nnz, k=k)
            for name, k in (("A.layer1", f), ("A.layer2", h),
                            ("At.layer2", h))]


def model_flops(cfg: dict, graph: dict) -> int:
    n, f = graph["nodes"], graph["features"]
    h, c = cfg["hidden"], graph["classes"]
    dense = (2 * n * f * h * 4      # agg Wl1, x Wr1, and both gradients
             + 2 * n * h * c * 6)   # agg Wl2, h Wr2, both weight gradients,
    #                                 and the gradients of agg and h
    return dense + sum(2 * a["nnz"] * a["k"]
                       for a in aggregations(cfg, graph))
