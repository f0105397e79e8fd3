"""The inputs: one seed, one graph; the published counts at a cut scale."""

import math

import pytest
import torch

from gnnbench import gen, spec


def cut(graph, by=64):
    n = graph["nodes"] // by
    e = graph["edges"] // by // 2 * 2
    train = n * 2 // 3
    return {**graph, "nodes": n, "edges": e, "features": 16,
            "split": dict(train=train, val=(n - train) // 2,
                          test=n - train - (n - train) // 2)}


LAYOUT = [("w", (16, 8), "glorot_uniform"), ("b", (8,), "zeros"),
          ("v", (16, 4), "lecun_normal")]


def inputs(seed, graph=None):
    return gen.make_inputs(graph or cut(spec.graph("reddit")), LAYOUT, seed,
                           torch.device("cpu"))


def test_same_seed_same_inputs():
    a, b = inputs(2**31 + 5), inputs(2**31 + 5)
    assert torch.equal(a.edge_index, b.edge_index)
    for k in ("x", "y", "train", "val", "test"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    # another seed: other features and parameters on the same structure
    c = inputs(2**31 + 6)
    assert torch.equal(a.edge_index, c.edge_index)
    assert not torch.equal(a.x, c.x)
    assert not torch.equal(a.params["w"], c.params["w"])
    graph = cut(spec.graph("reddit"))
    graph["law"] = {**graph["law"], "structure_seed": 2}
    assert not torch.equal(a.edge_index, inputs(2**31 + 5, graph).edge_index)


# each graph file's published (nodes, edges, features, classes)
PUBLISHED = {"reddit": (232_965, 114_615_892, 602, 41),
             "mag": (736_389, 10_832_542, 128, 349)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_counts_at_a_cut_scale(name):
    full = spec.graph(name)
    assert (full["nodes"], full["edges"], full["features"],
            full["classes"]) == PUBLISHED[name]
    assert sum(full["split"].values()) == full["nodes"]
    graph = cut(full)
    a = inputs(3, graph)
    n, e = graph["nodes"], graph["edges"]
    assert (n, e) == (full["nodes"] // 64, full["edges"] // 64 // 2 * 2)
    assert a.edge_index.shape == (2, e)
    src, dst = a.edge_index
    assert int(src.min()) >= 0 and int(src.max()) < n
    assert not bool((src == dst).any())
    half = e // 2   # mirrored: the second half is the first reversed
    assert torch.equal(src[half:], dst[:half])
    assert torch.equal(dst[half:], src[:half])
    assert a.x.shape == (n, 16) and a.x.dtype == torch.float32
    assert int(a.y.max()) < graph["classes"]
    masks = torch.stack([a.train, a.val, a.test])
    assert bool((masks.sum(0) == 1).all())   # every node in one part
    assert [int(m.sum()) for m in masks] == \
        [graph["split"][p] for p in ("train", "val", "test")]


def test_parameter_laws():
    p = inputs(9).params
    assert float(p["w"].abs().max()) <= math.sqrt(6 / 24)
    assert float(p["b"].abs().max()) == 0.0
    std = math.sqrt(1 / 16) / 0.87962566103423978
    assert float(p["v"].abs().max()) <= 2 * std * (1 + 1e-6)
    assert float(p["v"].std()) > 0.5 * std


def test_rmat_law_skews_degrees():
    src, dst = gen.rmat(1024, 20000, 0.57, 0.19, 0.19,
                        torch.Generator().manual_seed(0), "cpu")
    deg = torch.bincount(dst, minlength=1024)
    assert int(deg.max()) > 20 * float(deg.float().mean())


def test_a_graph_that_is_not_mirrored():
    graph = {**cut(spec.graph("reddit")), "edges": 999}
    graph["law"] = {**graph["law"], "mirrored": False}
    src, dst = inputs(4, graph).edge_index
    assert src.numel() == 999 and not bool((src == dst).any())
