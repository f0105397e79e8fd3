"""The port's GraphSAGE and GIN slice against the JAX package: layers and
models with converted flax weights (rtol 1e-5 and atol 1e-5 of the layer's
largest output: fp32 on both sides, only the order of the sums differs),
BatchNorm statistics, three Adam steps (1e-4, as the GCN parity test), the
loss, transforms, loaders and the CLI."""

import copy
import dataclasses
import zlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import isplib_tpu.nn as jnn
from isplib_tpu.data import loaders as jax_loaders
from isplib_tpu.data.synthetic import rmat_dataset as jax_rmat_dataset
from isplib_tpu.data.synthetic import sbm_dataset as jax_sbm_dataset
from isplib_tpu.nn.models import _GINMLP as JaxGINMLP
from isplib_tpu.train import train_node_classifier as jax_train
from isplib_tpu.train.loop import make_train_step
import isplib_tpu_torch as pt
from isplib_tpu_torch import run_model
from isplib_tpu_torch.data import (load, pad_features, rmat_dataset,
                                   sbm_dataset)
from isplib_tpu_torch.data.loaders import standin_seed
from isplib_tpu_torch.kernels import spmm_minmax_v4 as k3
from isplib_tpu_torch.nn.models import _GINMLP
from isplib_tpu_torch.sparse.graph import _ARRAY_FIELDS
from isplib_tpu_torch.train.loop import _loss_fn

SBM = dict(num_nodes=300, num_classes=5, num_features=16, avg_degree=8.0,
           seed=1, edge_multiple=128)


def assert_close(got, want, **kw):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1.0),
                               **kw)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same_graph(tg, jg):
    assert (tg.num_rows, tg.num_cols, tg.nnz) == (jg.num_rows, jg.num_cols,
                                                   jg.nnz)
    for f in _ARRAY_FIELDS:
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def assert_same_dataset(ds, jds):
    assert_same_graph(ds.graph, jds.graph)
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f),
                                      err_msg=f)
    assert (ds.name, ds.num_classes) == (jds.name, jds.num_classes)


@pytest.fixture(scope="module")
def sbm():
    """The same SBM dataset in both packages."""
    return sbm_dataset(device="cpu", **SBM), jax_sbm_dataset(**SBM)


# ---- layers -----------------------------------------------------------------

@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_sage_conv_matches_flax(sbm, aggr):
    ds, jds = sbm
    conv = jnn.SAGEConv(8, aggr=aggr, backend="xla")
    params = np_tree(conv.init(jax.random.PRNGKey(0), jds.graph,
                               jnp.asarray(jds.x))["params"])
    want = conv.apply({"params": params}, jds.graph, jnp.asarray(jds.x))
    m = pt.SAGEConv(16, 8, aggr, device="cpu")
    m.load_state_dict({f"{lin}.{n}": torch.tensor(params[lin][n])
                       for lin, n in (("lin_l", "kernel"), ("lin_l", "bias"),
                                      ("lin_r", "kernel"))})
    with torch.no_grad():
        got = m(ds.graph, torch.from_numpy(ds.x))
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("eps,train_eps", [(0.0, False), (0.5, True)])
def test_gin_conv_matches_flax(sbm, eps, train_eps):
    ds, jds = sbm
    conv = jnn.GINConv(partial(JaxGINMLP, 8, 8), eps=eps,
                       train_eps=train_eps, backend="xla")
    params = np_tree(conv.init(jax.random.PRNGKey(0), jds.graph,
                               jnp.asarray(jds.x))["params"])
    want = conv.apply({"params": params}, jds.graph, jnp.asarray(jds.x))
    m = pt.GINConv(_GINMLP(16, 8, 8, "cpu", torch.Generator()), eps=eps,
                   train_eps=train_eps)
    state = {f"mlp.dense_{i}.{n}": torch.tensor(
        params["_GINMLP_0"][f"Dense_{i}"][n])
        for i in (0, 1) for n in ("kernel", "bias")}
    if train_eps:
        state["eps"] = torch.tensor(float(params["eps"]))
        assert isinstance(m.eps, torch.nn.Parameter)
    m.load_state_dict(state)
    with torch.no_grad():
        got = m(ds.graph, torch.from_numpy(ds.x))
    assert_close(got.numpy(), want)


def test_dense_init_follows_lecun_normal():
    """flax's Dense kernel: a normal truncated at 2 standard deviations,
    variance 1 / fan_in; bias zeros."""
    d = pt.nn.Dense(400, 300, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    w = d.kernel.detach().numpy()
    std = (1.0 / 400) ** 0.5 / 0.87962566103423978
    assert w.shape == (400, 300) and np.abs(w).max() <= 2 * std
    assert abs(w.std() / (1.0 / 400) ** 0.5 - 1.0) < 0.02
    assert not d.bias.detach().any()


# ---- models, layer by layer --------------------------------------------------

def _jax_model(name):
    if name == "gin":
        return jnn.GIN(hidden=8, num_classes=5, backend="xla")
    return jnn.GraphSAGE(hidden=8, num_classes=5, aggr=name.split("-")[1],
                         dropout_rate=0.0, backend="xla")


def _port_model(name, variables):
    if name == "gin":
        m = pt.GIN(16, hidden=8, num_classes=5, device="cpu")
        m.load_state_dict(pt.gin_params_from_flax(
            variables["params"], variables["batch_stats"]))
    else:
        m = pt.GraphSAGE(16, hidden=8, num_classes=5,
                         aggr=name.split("-")[1], dropout_rate=0.0,
                         device="cpu")
        m.load_state_dict(pt.sage_params_from_flax(variables["params"]))
    return m


MODELS = ["sage-max", "sage-mean", "sage-sum", "gin"]


@pytest.mark.parametrize("name", MODELS)
def test_models_match_flax_layer_by_layer(sbm, name):
    ds, jds = sbm
    jmodel = _jax_model(name)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), jds.graph,
                                    jnp.asarray(jds.x)))
    _, inter = jmodel.apply(variables, jds.graph, jnp.asarray(jds.x),
                            capture_intermediates=True)
    inter = inter["intermediates"]
    m = _port_model(name, variables).eval()
    got = {}
    layers = [n for n in ("conv1", "bn1", "conv2", "bn2", "fc1", "fc2")
              if hasattr(m, n)]
    for n in layers:
        getattr(m, n).register_forward_hook(
            lambda mod, inp, out, n=n: got.__setitem__(n, out))
    with torch.no_grad():
        logits = m(ds.graph, torch.from_numpy(ds.x))
    for n in layers:
        assert_close(got[n].numpy(), inter[n]["__call__"][0], err_msg=n)
    assert_close(logits.numpy(), inter["__call__"][0])


@pytest.mark.parametrize("name", ["sage-max", "gin"])
def test_three_adam_steps_match_jax(sbm, name):
    """Three train steps (dropout 0): losses and parameters within 1e-4,
    GIN's BatchNorm running statistics within 1e-5.

    GIN's two biases right before a BatchNorm are held fixed on both sides:
    the BatchNorm subtracts the batch mean, so their gradient is zero up to
    rounding, and Adam scales that rounding noise up to steps of about its
    learning rate, different in each framework (measured: 3e-3 apart after
    3 steps, every other parameter within 3e-7)."""
    ds, jds = sbm
    jmodel = _jax_model(name)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), jds.graph,
                                    jnp.asarray(jds.x)))
    has_bs = name == "gin"
    loss = "ce" if has_bs else "nll"
    pre_bn = {("conv1", "_GINMLP_0", "Dense_1", "bias"),
              ("conv2", "_GINMLP_0", "Dense_1", "bias")} if has_bs else set()
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, _: tuple(k.key for k in path) in pre_bn,
        variables["params"])
    optimizer = optax.chain(optax.masked(optax.set_to_zero(), frozen),
                            optax.add_decayed_weights(5e-4),
                            optax.adam(0.01))
    step = make_train_step(jmodel, optimizer, jds.graph, loss=loss,
                           has_batch_stats=has_bs)
    params, bstats = variables["params"], variables.get("batch_stats")
    opt_state = optimizer.init(params)
    jlosses = []
    for _ in range(3):
        params, bstats, opt_state, lval, _ = step(
            params, bstats, opt_state, jnp.asarray(jds.x),
            jnp.asarray(jds.y), jnp.asarray(jds.train_mask),
            jax.random.PRNGKey(1))
        jlosses.append(float(lval))

    m = _port_model(name, variables).train()
    if has_bs:
        m.conv1.mlp.dense_1.bias.requires_grad_(False)
        m.conv2.mlp.dense_1.bias.requires_grad_(False)
    opt = torch.optim.Adam(m.parameters(), lr=0.01, weight_decay=5e-4)
    x, y = torch.from_numpy(ds.x), torch.from_numpy(ds.y)
    mask = torch.from_numpy(ds.train_mask)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        lval = _loss_fn(m(ds.graph, x), y, mask, loss)
        lval.backward()
        opt.step()
        losses.append(float(lval.detach()))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)

    want = (pt.gin_params_from_flax(np_tree(params), np_tree(bstats))
            if has_bs else pt.sage_params_from_flax(np_tree(params)))
    got = m.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        tol = 1e-5 if key.endswith((".mean", ".var")) else 1e-4
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=key)


def test_ce_loss_matches_optax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(20, 5)).astype(np.float32) * 3
    y = rng.integers(0, 5, 20).astype(np.int32)
    mask = rng.random(20) < 0.5
    got = _loss_fn(torch.from_numpy(logits), torch.from_numpy(y),
                   torch.from_numpy(mask), "ce")
    per = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(y))
    want = jnp.sum(per * mask) / mask.sum()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        _loss_fn(torch.from_numpy(logits), torch.from_numpy(y),
                 torch.from_numpy(mask), "mse")


# ---- the training loop ------------------------------------------------------

def test_warmup_restores_params_and_batch_stats(sbm):
    """The warm-up epoch moves the parameters and BatchNorm's running
    statistics; both are restored before the timed epochs (0 here)."""
    ds, _ = sbm
    model = pt.GIN(16, hidden=8, num_classes=5, device="cpu")
    init = copy.deepcopy(model.state_dict())
    pt.train_node_classifier(model, ds, epochs=0, device="cpu")
    for key, v in model.state_dict().items():
        assert torch.equal(v, init[key]), key


@pytest.mark.parametrize("name,loss", [("gin", "ce"), ("sage-max", "nll")])
def test_default_loss_follows_batch_stats(sbm, name, loss):
    """'ce' for a model with batch statistics (GIN), else 'nll'; the first
    timed epoch's loss is the initial model's in training mode."""
    ds, _ = sbm
    if name == "gin":
        model = pt.GIN(16, hidden=8, num_classes=5, device="cpu")
    else:
        model = pt.GraphSAGE(16, hidden=8, num_classes=5, aggr="max",
                             dropout_rate=0.0, device="cpu")
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        want = float(_loss_fn(probe(ds.graph, torch.from_numpy(ds.x)),
                              torch.from_numpy(ds.y),
                              torch.from_numpy(ds.train_mask), loss))
    res = pt.train_node_classifier(model, ds, epochs=1, device="cpu")
    np.testing.assert_allclose(res.losses[0], want, rtol=1e-6)


@pytest.mark.parametrize("tile", [True, False])
def test_tile_flag_picks_the_spmm_path(monkeypatch, sbm, tile):
    """With ``tile`` a TiledGraph trains through its kernels (their plain
    versions on the CPU); without it, through the reference path on the
    plain graph.  The aggregation is exact, so the losses agree."""
    ds, _ = sbm
    calls = []
    plain = k3.spmm_minmax_v4_plain
    monkeypatch.setattr(k3, "spmm_minmax_v4_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tiled = dataclasses.replace(ds, graph=pt.build_tiling(ds.graph))

    def run(dataset, **kw):
        model = pt.GraphSAGE(16, hidden=8, num_classes=5, aggr="max",
                             dropout_rate=0.0, device="cpu")
        return pt.train_node_classifier(model, dataset, epochs=2,
                                        device="cpu", **kw).losses

    want = run(ds)
    assert calls == []
    got = run(tiled, tile=tile)
    assert (len(calls) > 0) == tile
    np.testing.assert_allclose(got, want, rtol=1e-6)


KARATE_EPOCHS = 30


@pytest.mark.parametrize("name", ["sage-max", "sage-mean", "gin"])
def test_karate_reaches_jax_test_accuracy(name):
    """Both loops from the weights the JAX loop draws (dropout 0, so the
    runs differ by rounding only): the port's test accuracy is the JAX
    run's or better."""
    ds, jds = load("karate", device="cpu"), jax_loaders.load("karate")
    if name == "gin":
        jmodel = jnn.GIN(hidden=16, num_classes=2, backend="xla")
        model = pt.GIN(ds.num_features, hidden=16, num_classes=2,
                       device="cpu")
    else:
        aggr = name.split("-")[1]
        jmodel = jnn.GraphSAGE(hidden=16, num_classes=2, aggr=aggr,
                               dropout_rate=0.0, backend="xla")
        model = pt.GraphSAGE(ds.num_features, hidden=16, num_classes=2,
                             aggr=aggr, dropout_rate=0.0, device="cpu")
    # the JAX loop's initial weights (train_node_classifier, seed 0)
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    variables = np_tree(jmodel.init(init_rng, jds.graph, jnp.asarray(jds.x),
                                    training=False))
    model.load_state_dict(
        pt.gin_params_from_flax(variables["params"],
                                variables["batch_stats"])
        if name == "gin" else pt.sage_params_from_flax(variables["params"]))
    want = jax_train(jmodel, jds, epochs=KARATE_EPOCHS)
    got = pt.train_node_classifier(model, ds, epochs=KARATE_EPOCHS,
                                   device="cpu")
    assert got.test_acc >= want.test_acc
    assert np.all(np.isfinite(got.losses)) and got.losses[-1] < got.losses[0]


# ---- transforms, data and the CLI -------------------------------------------

def test_row_normalize_matches_jax(sbm):
    ds, jds = sbm
    assert_same_graph(pt.row_normalize(ds.graph, edge_multiple=128),
                      jnn.row_normalize(jds.graph, edge_multiple=128))


@pytest.mark.parametrize("name", ["karate", "lesmis"])
def test_real_graphs_load_as_in_jax(name):
    assert_same_dataset(load(name, device="cpu"), jax_loaders.load(name))


def test_rmat_dataset_and_standin_match_jax(monkeypatch):
    from isplib_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    kw = dict(num_nodes=500, num_edges=4000, num_features=12,
              num_classes=4, seed=9, edge_multiple=128)
    assert_same_dataset(rmat_dataset(device="cpu", **kw),
                        jax_rmat_dataset(**kw))
    # the port's stand-ins take a per-process-stable seed; the JAX
    # package's stand-in with that seed is the same dataset
    ds = load("mag-sim", scale=0.001, device="cpu")
    n, e, f, c = jax_loaders.DATASET_STATS["mag"]
    jds = jax_rmat_dataset(num_nodes=int(n * 0.001),
                           num_edges=int(e * 0.001), num_features=f,
                           num_classes=c, name="mag-sim",
                           seed=standin_seed("mag"), undirected=False)
    assert_same_dataset(ds, jds)
    assert standin_seed("reddit") == zlib.crc32(b"reddit") & 0x7FFFFFFF
    assert pad_features(ds) is ds  # 128 features already
    karate = load("karate", device="cpu")
    padded = pad_features(karate)
    assert (karate.num_features, padded.num_features) == (34, 128)
    np.testing.assert_array_equal(padded.x[:, :34], karate.x)
    assert not padded.x[:, 34:].any()


@pytest.mark.parametrize("mode,tile", [("auto", True), ("reference", False)])
def test_run_model_mode_sets_tiling(monkeypatch, mode, tile):
    """The CLI's ``reference`` mode trains untiled (no kernel runs)."""
    seen = []
    train = pt.train.train_node_classifier
    monkeypatch.setattr(pt.train, "train_node_classifier",
                        lambda *a, **kw: seen.append(kw["tile"])
                        or train(*a, **kw))
    assert run_model.main(["gcn", "karate", mode, "--epochs", "1",
                           "--device", "cpu"]) == 0
    assert seen == [tile]


def test_run_model_cli_on_karate(capsys):
    assert run_model.main(["sage", "karate", "--aggr", "max", "--epochs",
                           "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("Running SAGE, Epoch: 3")
    i = lines.index("TRG_TM\tTRG_STD\tTST_TM\tTRG_ACC\tTST_ACC")
    assert len(lines[i + 2].split("\t")) == 5
    assert len(lines[-2].split(",")) == 5 and lines[-1] == "---"
