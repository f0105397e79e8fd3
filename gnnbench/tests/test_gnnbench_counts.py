"""The aggregation bound and the model operations, counted by hand."""

import pytest

from gnnbench import bound, spec

# 4 nodes, 6 edges, no self loops; 3 features, 2 classes; hidden 2
GRAPH = dict(nodes=4, edges=6, features=3, classes=2,
             law=dict(self_loops=False))
CFG = dict(hidden=2)
PEAK = dict(hbm_bytes_per_s=1.0, bf16_tensor_flops_per_s=1.0,
            fp32_ops_per_s=1.0)


def test_gcn_aggregations_and_bound():
    aggs = spec.module("counts", "gcn").aggregations(CFG, GRAPH)
    assert [a["k"] for a in aggs] == [2, 2, 2, 2]
    a = aggs[0]
    assert (a["kind"], a["rows"], a["cols"], a["nnz"]) == ("sum", 4, 4, 10)
    # 4·10 indices + 4·5 row pointers + 4·4·2 read + 4·4·2 written
    assert bound.aggregation_bytes(a) == 40 + 20 + 32 + 32
    assert bound.aggregation_ops(a) == (40, "bf16_tensor_flops_per_s")
    assert bound.aggregation_bound_s(a, PEAK) == 124.0


def test_gcn_flops():
    # x W1 and its gradient: 2 · 2·4·3·2; h W2, its two gradients:
    # 3 · 2·4·2·2; four sums: 4 · 2·10·2
    assert spec.module("counts", "gcn").model_flops(CFG, GRAPH) == \
        96 + 96 + 160


def test_sage_max_aggregations_and_flops():
    counts = spec.module("counts", "sage_max")
    aggs = counts.aggregations(CFG, GRAPH)
    assert [(a["kind"], a["nnz"], a["k"]) for a in aggs] == \
        [("max", 6, 3), ("max", 6, 2), ("route", 0, 2)]
    assert bound.aggregation_ops(aggs[0]) == (18, "fp32_ops_per_s")
    # the route reads 4·2 cotangents and winners, writes 4·2
    assert bound.aggregation_bytes(aggs[2]) == 8 * 4 * 2 + 4 * 4 * 2
    assert bound.aggregation_ops(aggs[2]) == (8, "fp32_ops_per_s")
    # 4 products at F: 4 · 2·4·3·2; 6 at hidden: 6 · 2·4·2·2; max 18 + 12;
    # the route 8
    assert counts.model_flops(CFG, GRAPH) == 192 + 192 + 30 + 8


def test_reddit_bound_at_32():
    """The issue's reckoning: ~519 MB at K = 32, 0.155 ms on the H100."""
    graph = spec.graph("reddit")
    peak = spec.peaks()["NVIDIA H100 80GB HBM3"]
    a = spec.module("counts", "gcn").aggregations(dict(hidden=32), graph)[0]
    assert a["nnz"] == 114_615_892 + 232_965
    assert bound.aggregation_bytes(a) == pytest.approx(519.9e6, rel=1e-3)
    assert bound.aggregation_bound_s(a, peak) == pytest.approx(
        0.1552e-3, rel=1e-3)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        bound.aggregation_ops(dict(kind="prod", rows=1, cols=1, nnz=1, k=1))
