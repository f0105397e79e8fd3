"""Each configuration's plain reference against a two-node example worked
by hand, and against torch's autograd of a dense form on a small graph."""

import math

import pytest
import torch
import torch.nn.functional as F

from gnnbench import spec
from gnnbench.reference import plain

# nodes 0 and 1, one edge each way
EDGES = torch.tensor([[0, 1], [1, 0]])
CFG = dict(hidden=2)
KEEP_ALL = torch.ones(2, 2, dtype=torch.bool)
BOTH = torch.ones(2, dtype=torch.bool)


def test_gcn_two_nodes():
    ref = spec.module("reference", "gcn")
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    y = torch.tensor([0, 1])
    model = ref.Model(EDGES, 2, x, y, CFG)
    p = {"conv1.kernel": torch.eye(2), "conv1.bias": torch.zeros(2),
         "conv2.kernel": torch.tensor([[1.0, 0.0], [0.0, 0.0]]),
         "conv2.bias": torch.zeros(2)}
    loss, g = model.loss_and_grads(p, KEEP_ALL, 1.0, BOTH)
    # Â = 1/2 everywhere (self loops, degree 2): a1 = [.5, .5] on both
    # rows, a2 = [.5, 0] on both rows
    assert float(loss) == pytest.approx(math.log(math.exp(0.5) + 1) - 0.25)
    s = math.exp(0.5) / (math.exp(0.5) + 1)
    assert g["conv2.bias"].tolist() == pytest.approx(
        [(2 * s - 1) / 2, (1 - 2 * s) / 2])
    # conv2.kernel's gradient: hᵀ Âᵀ g2, h = .5 everywhere
    assert g["conv2.kernel"].flatten().tolist() == pytest.approx(
        [(2 * s - 1) / 4, (1 - 2 * s) / 4] * 2)


def test_sage_max_two_nodes():
    ref = spec.module("reference", "sage_max")
    x = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    y = torch.tensor([1, 0])
    model = ref.Model(EDGES, 2, x, y, CFG)
    # each node's only neighbour is the other: agg(x) = x swapped
    assert model.agg_x.tolist() == [[3.0, 4.0], [1.0, -2.0]]
    eye, zero = torch.eye(2), torch.zeros(2)
    p = {"conv1.lin_l.kernel": eye, "conv1.lin_l.bias": zero,
         "conv1.lin_r.kernel": torch.zeros(2, 2),
         "conv2.lin_l.kernel": eye, "conv2.lin_l.bias": zero,
         "conv2.lin_r.kernel": torch.zeros(2, 2)}
    loss, g = model.loss_and_grads(p, KEEP_ALL, 1.0, BOTH)
    # h = relu(agg x) = [[3, 4], [1, 0]]; a2 = agg h = [[1, 0], [3, 4]]
    lp0 = -math.log(math.exp(1) + 1)          # node 0, class 1
    lp1 = 3 - math.log(math.exp(3) + math.exp(4))   # node 1, class 0
    assert float(loss) == pytest.approx(-(lp0 + lp1) / 2)
    # the max's gradient routes to the winner: node 1's row of a2 came
    # from node 0, so conv1.lin_r (zero) aside, conv1.lin_l.bias gathers
    # both rows' routed cotangents through the relu
    sm0 = torch.softmax(torch.tensor([1.0, 0.0]), 0)
    sm1 = torch.softmax(torch.tensor([3.0, 4.0]), 0)
    g2 = torch.stack([sm0 - torch.tensor([0.0, 1.0]),
                      sm1 - torch.tensor([1.0, 0.0])]) / 2
    # ga1 row 0 = g2 row 1 (a2[1] = h[0]); row 1 = g2 row 0 masked by
    # relu'(a1[1]) = (1 > 0, -2 > 0)
    want = g2[1] + g2[0] * torch.tensor([1.0, 0.0])
    assert g["conv1.lin_l.bias"].tolist() == pytest.approx(want.tolist())


def test_max_ties_go_to_the_lowest_column():
    adj = plain.Adjacency(torch.tensor([0, 0, 0]), torch.tensor([2, 1, 2]),
                          None, 3, 3)
    out, arg = adj.max(torch.tensor([[0.0], [5.0], [5.0]]))
    assert out.tolist() == [[5.0], [0.0], [0.0]]
    assert arg.tolist() == [[1], [-1], [-1]]


def dense_agg(cfg, a_dense, t):
    """The configuration's aggregation over a dense adjacency that holds
    each entry's multiplicity (or Â's values)."""
    aggr = cfg.get("aggregation", "sum")
    if aggr == "max":
        big = torch.where(a_dense[..., None] > 0, t[None],
                          torch.full_like(t[None], float("-inf")))
        m = big.max(1).values
        return torch.where(torch.isinf(m), torch.zeros_like(m), m)
    out = a_dense @ t
    if aggr == "mean":
        return out / a_dense.sum(1, keepdim=True).clamp(min=1.0)
    assert aggr == "sum", aggr
    return out


def dense_loss(cfg, p, x, y, a_dense, keep_mask, keep, train):
    """The same model by torch's autograd on a dense adjacency."""
    def agg(t):
        return dense_agg(cfg, a_dense, t)
    if cfg["model"] == "GCN":
        a1 = agg(x @ p["conv1.kernel"]) + p["conv1.bias"]
        h = plain.dropout(torch.relu(a1), keep_mask, keep)
        a2 = agg(h @ p["conv2.kernel"]) + p["conv2.bias"]
    else:
        assert cfg["model"] == "GraphSAGE", cfg["model"]
        a1 = (agg(x) @ p["conv1.lin_l.kernel"] + p["conv1.lin_l.bias"]
              + x @ p["conv1.lin_r.kernel"])
        h = plain.dropout(torch.relu(a1), keep_mask, keep)
        a2 = (agg(h) @ p["conv2.lin_l.kernel"] + p["conv2.lin_l.bias"]
              + h @ p["conv2.lin_r.kernel"])
    lp = F.log_softmax(a2, -1)
    m = train.double()
    return -(lp.gather(1, y[:, None])[:, 0] * m).sum() / m.sum()


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.benchmark()["configs"]])
def test_gradients_match_autograd(name):
    """Every configuration's reference against torch's autograd of a dense
    form: this file's for GCN and GraphSAGE (sum, mean, max), or the
    reference's own ``dense_loss(cfg, p, x, y, edge_index, n, keep_mask,
    keep, train)`` for a model that it lacks.  Duplicate edges, and the
    last node left without any (its mean divides by max(deg, 1), GCN gives
    it a self loop)."""
    torch.manual_seed(0)
    n, f, c, h = 30, 5, 3, 4
    src = torch.randint(0, n - 1, (80,))
    dst = torch.randint(0, n - 1, (80,))
    keep = src != dst
    ei = torch.stack([torch.cat([src[keep], dst[keep]]),
                      torch.cat([dst[keep], src[keep]])])
    assert ei.unique(dim=1).shape[1] < ei.shape[1]   # duplicates
    ref = spec.module("reference", name)
    cfg = {**spec.config(spec.benchmark(), name), "hidden": h}
    p = {k: torch.randn(shape, dtype=torch.float64)
         for k, shape, _ in ref.parameters(cfg, f, c)}
    x = torch.randn(n, f, dtype=torch.float64)
    y = torch.randint(0, c, (n,))
    train = torch.rand(n) < 0.7
    keep_mask = torch.rand(n, h) < 0.5
    model = ref.Model(ei, n, x, y, cfg)
    loss, grads = model.loss_and_grads(p, keep_mask, 0.5, train)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    if hasattr(ref, "dense_loss"):   # a model that the one here lacks
        want = ref.dense_loss(cfg, leaves, x, y, ei, n, keep_mask, 0.5,
                              train)
    else:
        a_dense = torch.zeros(n, n, dtype=torch.float64)
        if cfg["transform"] == "gcn_norm":
            row, col, val = ref.normalized(ei, n)
            a_dense.index_put_((row, col), val.double(), accumulate=True)
        else:
            assert cfg["transform"] is None, cfg["transform"]
            a_dense.index_put_((ei[1], ei[0]),
                               torch.ones(ei.shape[1], dtype=torch.float64),
                               accumulate=True)
        want = dense_loss(cfg, leaves, x, y, a_dense, keep_mask, 0.5, train)
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    for k in p:
        assert torch.allclose(grads[k], leaves[k].grad, rtol=1e-5,
                              atol=1e-7), k


def test_adam_matches_torch():
    torch.manual_seed(1)
    p = {"w": torch.randn(4, 3)}
    w = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.Adam([w], lr=0.01, weight_decay=5e-4)
    adam = plain.Adam(p, 0.01, (0.9, 0.999), 1e-8, 5e-4)
    for _ in range(3):
        g = torch.randn(4, 3)
        w.grad = g.clone()
        opt.step()
        p, _ = adam.step(p, {"w": g})
    assert torch.allclose(p["w"], w.detach(), rtol=1e-6, atol=1e-7)


def test_precisions_round():
    t = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, 3.0])
    assert plain.round_tf32(t).tolist() == [1.0, 1.0 + 2**-10, 3.0]
    q = plain.quantize(torch.tensor([448.0, 1.0 + 2**-5]), "float8_e4m3")
    assert q.tolist() == [448.0, 1.0]
