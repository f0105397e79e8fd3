"""GAT in the port: ``nn.GATConv`` and ``nn.models.GAT`` against the plain
reference of the benchmark (``gnnbench/reference/gat.py``), the attention
op's autograd, its tiled path against its plain path, and the guard that
the tiled path runs no plain op.

The tests marked ``gpu`` hold the CUDA kernels (``kernels/gat_attention``)
against the plain path on a card; without JAX there, run them as

    python -m pytest --noconftest tests/test_torch_gat.py -q -m gpu
"""

import numpy as np
import pytest
import torch

import isplib_tpu_torch as pt
from isplib_tpu_torch.kernels import gat_attention as katt
from isplib_tpu_torch.nn import GAT, MODEL_REGISTRY
from isplib_tpu_torch.ops import reference
from isplib_tpu_torch.ops.attention import _pad, attention
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.sparse.tiling_v5 import SEG_EDGES
from isplib_tpu_torch.train import make_train_step

from gnnbench import gen, spec
from gnnbench.reference import plain


def small_graph(n=60, e=300, seed=0, device="cpu"):
    """Random edges with duplicates, two self loops of the graph's own and
    node n - 1 without any edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, e)
    dst = rng.integers(0, n - 1, e)
    src = np.concatenate([src, src[:20], [3, 5]])
    dst = np.concatenate([dst, dst[:20], [3, 5]])
    return pt.from_edge_index(np.stack([src, dst]), num_nodes=n,
                              device=device)


def hub_graph(device="cpu", n=700):
    """A hub row cut into three segments, a hub column, a self loop of the
    graph's own, an empty row (n - 1) and rows of a few entries (fewer
    than the 8 that ``att_bwd_e`` sums before a reduction), over a dense
    corner."""
    rng = np.random.default_rng(1)
    hub = 2 * SEG_EDGES + 10
    dst = np.concatenate([rng.integers(0, 64, 2000),
                          rng.integers(0, n - 1, 1500), np.full(hub, 7),
                          rng.integers(0, n - 1, hub), [9]])
    src = np.concatenate([rng.integers(0, 64, 2000),
                          rng.integers(0, n - 1, 1500),
                          rng.integers(0, n - 1, hub), np.full(hub, 11),
                          [9]])
    return pt.from_edge_index(np.stack([src, dst]), num_nodes=n,
                              edge_multiple=128, device=device)


def operands(n, heads, c, dtype=torch.float32, device="cpu", seed=0):
    gen_ = torch.Generator().manual_seed(seed)
    x = torch.randn(n, heads * c, generator=gen_, dtype=dtype)
    s_src = torch.randn(n, heads, generator=gen_, dtype=dtype)
    s_dst = torch.randn(n, heads, generator=gen_, dtype=dtype)
    return [t.to(device).requires_grad_() for t in (x, s_src, s_dst)]


def run_op(graph, ops, backend, seed=1):
    out = attention(graph, *ops, 0.2, backend)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed)).to(out.device)
    grads = torch.autograd.grad((out * w).sum(), ops)
    return [out.detach(), *grads]


def test_gat_is_a_registered_model():
    assert MODEL_REGISTRY["gat"] is GAT


@pytest.mark.parametrize("heads,c", [(1, 3), (2, 5), (3, 4)])
def test_attention_gradcheck(heads, c):
    """float64 on the plain path: duplicate edges, the graph's own self
    loops (replaced by the op's), an isolated node (its self loop
    alone)."""
    g = small_graph(n=24, e=70)
    ops = [t.detach().requires_grad_() for t in operands(
        24, heads, c, torch.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: attention(g, *a, 0.2, "reference"), ops)


def test_attention_by_hand():
    """Node 0 with in-edges from 1 twice and from 2; node 3 alone: α over
    the entries (1, 1, 2, 0) and node 3's own row unchanged."""
    g = pt.from_edge_index(np.array([[1, 1, 2], [0, 0, 0]]), num_nodes=4,
                           device="cpu")
    x = torch.arange(8.0).view(4, 2)
    s_src = torch.tensor([[0.5], [1.0], [-2.0], [0.0]])
    s_dst = torch.tensor([[0.25], [0.0], [0.0], [0.0]])
    out = attention(g, x, s_src, s_dst, 0.2, "reference")
    z = torch.tensor([1.0, 1.0, -2.0, 0.5]) + 0.25
    e = torch.where(z > 0, z, 0.2 * z)
    a = torch.softmax(e, 0)
    want = a[0] * x[1] + a[1] * x[1] + a[2] * x[2] + a[3] * x[0]
    assert torch.allclose(out[0], want)
    assert torch.equal(out[3], x[3])


@pytest.mark.parametrize("heads,c", [(1, 41), (4, 8), (6, 41), (3, 12)])
def test_tiled_path_matches_plain_path(heads, c):
    """A CPU TiledGraph runs the kernels' plain versions over the segment
    lists (a hub row and a hub column cut into segments, an empty row,
    heads padded to a multiple of 4): the same output and gradients as the
    plain path."""
    g = hub_graph()
    tiled = build_tiling(g, dense_threshold=128)
    assert tiled.fwd_mm.nsplit and tiled.bwd_mm.nsplit
    want = run_op(g, operands(g.num_rows, heads, c), "reference")
    got = run_op(tiled, operands(g.num_rows, heads, c), "auto")
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


def test_tiled_path_reaches_no_plain_op(monkeypatch):
    """The op on a TiledGraph dispatches to ``kernels/gat_attention`` alone:
    the plain op's forward and backward are never called."""
    tiled = build_tiling(hub_graph(), dense_threshold=128)

    def refuse(*a, **k):
        raise AssertionError("the plain attention ran")
    monkeypatch.setattr(reference, "attention_raw", refuse)
    monkeypatch.setattr(reference, "attention_backward_raw", refuse)
    run_op(tiled, operands(tiled.num_rows, 2, 8), "auto")


@pytest.mark.parametrize("value_grad", [False, True])
def test_auto_tiles_a_csr_graph_whatever_its_values(monkeypatch, tmp_path,
                                                    value_grad):
    """Under ``"auto"`` a CSRGraph that ``auto_tile`` takes is tiled, also
    where its edge values need a gradient (the attention never reads
    them): the op runs the kernels' path and matches the plain path."""
    from isplib_tpu_torch.sparse import tiling
    from isplib_tpu_torch.tune import autotune
    monkeypatch.setattr(tiling, "AUTO_TILE_MIN_NNZ", 100)
    monkeypatch.setattr(tiling, "_on_cuda", lambda g: True)
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "tune.json"))
    monkeypatch.setattr(autotune, "_memory_cache", None)
    monkeypatch.setenv("ISPLIB_TPU_TORCH_CACHE_DIR", str(tmp_path / "plans"))
    g = hub_graph()
    if value_grad:
        g = g.with_value(g.value.clone().requires_grad_())
    calls = []
    forward = katt.forward
    monkeypatch.setattr(katt, "forward",
                        lambda *a: calls.append(a) or forward(*a))
    got = run_op(g, operands(g.num_rows, 2, 8), "auto")
    assert calls
    want = run_op(g, operands(g.num_rows, 2, 8), "reference")
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_operands():
    tiled = build_tiling(hub_graph(), dense_threshold=128)
    n, col = tiled.num_rows, tiled.graph.col
    ok = torch.zeros(n, 2)
    for x, s in ((torch.zeros(n, 18), ok),            # Cp = 9
                 (torch.zeros(n, 2048), ok),          # too wide
                 (torch.zeros(n, 72), torch.zeros(n, 9)),   # 9 heads
                 (torch.zeros(n, 8, dtype=torch.float64), ok),
                 (torch.zeros(n + 1, 8), ok)):
        with pytest.raises(ValueError):
            katt.forward(tiled.fwd_mm, col, x, s, s, 0.2)


def gat_inputs(n=150, f=12, c=5, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 900)
    dst = rng.integers(0, n, 900)
    edge_index = np.stack([src, dst])
    gen_ = torch.Generator().manual_seed(seed)
    x = torch.randn(n, f, generator=gen_)
    y = torch.randint(0, c, (n,), generator=gen_)
    train = torch.rand(n, generator=gen_) < 0.6
    return edge_index, x, y, train


def test_gat_trains_like_the_reference():
    """One step of ``make_train_step`` on GAT (heads and widths cut) from
    the reference's seeded parameters: the loss, every gradient and the
    parameters after Adam's step within 1e-5 of the plain reference."""
    n, f, c = 150, 12, 5
    edge_index, x, y, train = gat_inputs(n, f, c)
    cfg = {**spec.config(spec.benchmark(), "gat"), "hidden": 6,
           "heads": [2, 2, 3]}
    ref = spec.module("reference", "gat")
    params = gen.draw_parameters(ref.parameters(cfg, f, c),
                                 torch.Generator().manual_seed(7), "cpu")
    model = GAT(f, hidden=6, num_classes=c, heads=(2, 2, 3), device="cpu")
    assert set(model.state_dict()) == set(params)
    model.load_state_dict(params)
    opt_cfg = cfg["optimizer"]
    opt = torch.optim.Adam(model.parameters(), lr=opt_cfg["lr"],
                           betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
    g = pt.from_edge_index(edge_index, num_nodes=n, device="cpu")
    step = make_train_step(model, opt, g, loss=cfg["loss"])
    loss, _ = step(x, y, train)

    plain_model = ref.Model(torch.from_numpy(edge_index), n, x, y, cfg)
    want_loss, want_grads = plain_model.loss_and_grads(
        params, torch.ones(n, 6, dtype=torch.bool), 1.0, train)
    adam = plain.Adam(params, opt_cfg["lr"], opt_cfg["betas"],
                      opt_cfg["eps"], opt_cfg["weight_decay"])
    want_params, _ = adam.step(params, want_grads)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k, p in model.named_parameters():
        assert torch.allclose(p.grad, want_grads[k], rtol=1e-5,
                              atol=1e-6), k
        assert torch.allclose(p.detach(), want_params[k], rtol=1e-5,
                              atol=1e-6), k


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("heads,c", [(1, 41), (6, 41), (4, 256), (1, 256),
                                     (2, 8), (8, 128)])
def test_kernels_match_plain_path(cuda, heads, c):
    """The kernels on a CUDA TiledGraph against the plain path on the same
    CUDA graph: fp32 on both sides, the sums in other orders (atomics on
    the split rows), so within 1e-4 of each output's scale."""
    g = hub_graph(cuda)
    tiled = build_tiling(g, dense_threshold=128)
    before = katt.LAUNCHES
    got = run_op(tiled, operands(g.num_rows, heads, c, device=cuda), "auto")
    assert katt.LAUNCHES - before == 6
    want = run_op(g, operands(g.num_rows, heads, c, device=cuda),
                  "reference")
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, (a - b).abs().max()


@pytest.mark.gpu
def test_cuda_path_calls_no_plain_function(cuda, monkeypatch):
    """GAT's step on a CUDA TiledGraph calls nothing of ``ops/reference.py``
    and launches the attention kernels."""
    g = hub_graph(cuda)
    tiled = build_tiling(g, dense_threshold=128)

    def refuse(*a, **k):
        raise AssertionError("ops/reference.py ran on the CUDA path")
    for name in reference.__all__:
        if callable(getattr(reference, name)):
            monkeypatch.setattr(reference, name, refuse)
    model = GAT(16, hidden=8, num_classes=5, heads=(2, 2, 3), device=cuda)
    opt = torch.optim.Adam(model.parameters(), lr=0.005)
    x = torch.randn(g.num_rows, 16, device=cuda)
    y = torch.randint(0, 5, (g.num_rows,), device=cuda)
    train = torch.ones(g.num_rows, dtype=torch.bool, device=cuda)
    before = katt.LAUNCHES
    loss, _ = make_train_step(model, opt, tiled)(x, y, train)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert katt.LAUNCHES - before == 18


@pytest.mark.gpu
@pytest.mark.parametrize("heads,c", [(4, 256), (6, 41), (8, 128), (1, 4),
                                     (3, 12)])
def test_backward_e_kernel_matches_plain_sums(cuda, heads, c):
    """``backward_e`` alone (``att_bwd_e`` and ``att_colsum``, one launch
    each) on a CUDA TiledGraph: ds_src and ds_dst against the plain
    per-entry products summed by column and by row, within 1e-4 of each
    output's scale (fp32 on both sides, the dots summed in other orders)."""
    g = hub_graph(cuda)
    tiled = build_tiling(g, dense_threshold=128)
    base, n = tiled.graph, g.num_rows
    x, s_src, s_dst = (t.detach() for t in operands(n, heads, c,
                                                    device=cuda))
    grad = torch.randn(n, heads * c, generator=torch.Generator()
                       .manual_seed(2)).to(cuda)
    xp, gp = _pad(x, heads), _pad(grad, heads)
    dst, src = reference.attention_edges(base.row, base.col, base.nnz, n)
    out, lse = reference.attention_raw(dst, src, xp, s_src, s_dst, n, 0.2)
    before = dict(katt.BY_KERNEL)
    dss, dsd = katt.backward_e(tiled.fwd_mm, base.col, tiled.bwd_mm,
                               base.csc2csr, gp, out, xp, s_src, s_dst, lse,
                               0.2)
    torch.cuda.synchronize()
    assert {k: katt.BY_KERNEL[k] - before[k] for k in katt.KERNELS} == {
        "att_stats": 0, "att_gather": 0, "att_bwd_e": 1, "att_colsum": 1}
    dz = reference.attention_edge_grad(dst, src, s_src, s_dst, lse, gp, out,
                                       xp, 0.2)
    for got, idx in ((dss, src), (dsd, dst)):
        want = dz.new_zeros(n, heads).index_add_(0, idx, dz)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
