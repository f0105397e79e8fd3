"""The port's training and tuning tools against the JAX package:
``make_train_step``, the plain-torch baseline (``pt1``), checkpoints,
profiling, ``findbestk`` and the loaders' ``tiling=``."""

import dataclasses
import importlib.util
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import isplib_tpu.nn as jnn
from isplib_tpu.data.synthetic import sbm_dataset as jax_sbm_dataset
from isplib_tpu.interop.torch_baseline import \
    train_torch_baseline as jax_baseline
from isplib_tpu.train.loop import make_train_step as jax_make_train_step
import isplib_tpu_torch as pt
from isplib_tpu_torch import findbestk, run_model
from isplib_tpu_torch.data import load, sbm_dataset
from isplib_tpu_torch.interop.torch_baseline import train_torch_baseline
from isplib_tpu_torch.sparse.graph import _ARRAY_FIELDS
from isplib_tpu_torch.sparse.tiling import TiledGraph, build_tiling
from isplib_tpu_torch.train import (checkpoint, latest_step,
                                    make_train_step, restore_checkpoint,
                                    save_checkpoint)
from isplib_tpu_torch.utils import Timer, op_report, trace

ROOT = Path(__file__).resolve().parent.parent
SBM = dict(num_nodes=300, num_classes=5, num_features=16, avg_degree=8.0,
           seed=1, edge_multiple=128)


@pytest.fixture(scope="module")
def ds():
    return sbm_dataset(device="cpu", **SBM)


def adam(model):
    return torch.optim.Adam(model.parameters(), lr=0.01, weight_decay=5e-4)


def tensors(ds):
    return (torch.from_numpy(ds.x), torch.from_numpy(ds.y),
            torch.from_numpy(ds.train_mask))


def make(name, ds):
    if name == "gcn":
        return pt.GCN(ds.num_features, 16, ds.num_classes, device="cpu",
                      seed=3)
    return pt.GIN(ds.num_features, 16, ds.num_classes, device="cpu", seed=3)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def test_make_train_step_matches_jax():
    """Three steps from the same flax parameters (dropout 0) give the JAX
    step's losses and parameters at 1e-4, as ``test_torch_gcn.py`` holds
    the hand-written loop."""
    port_ds = sbm_dataset(device="cpu", **SBM)
    graph = pt.gcn_norm(port_ds.graph, edge_multiple=128)
    jds = jax_sbm_dataset(**SBM)
    jgraph = jnn.gcn_norm(jds.graph, edge_multiple=128)
    model = jnn.GCN(hidden=16, num_classes=5, dropout_rate=0.0,
                    backend="xla")
    params = model.init(jax.random.PRNGKey(0), jgraph,
                        jnp.asarray(jds.x))["params"]
    optimizer = optax.chain(optax.add_decayed_weights(5e-4),
                            optax.adam(0.01))
    jstep = jax_make_train_step(model, optimizer, jgraph)
    opt_state = optimizer.init(params)
    jparams, jlosses = params, []
    for _ in range(3):
        jparams, _, opt_state, lval, _ = jstep(
            jparams, None, opt_state, jnp.asarray(jds.x),
            jnp.asarray(jds.y), jnp.asarray(jds.train_mask),
            jax.random.PRNGKey(1))
        jlosses.append(float(lval))

    m = pt.GCN(16, hidden=16, num_classes=5, dropout_rate=0.0, device="cpu")
    m.load_state_dict(pt.gcn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    step = make_train_step(m, adam(m), graph)
    losses = [float(step(*tensors(port_ds))[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    for layer in ("conv1", "conv2"):
        for name in ("kernel", "bias"):
            np.testing.assert_allclose(
                m.state_dict()[f"{layer}.{name}"].numpy(),
                np.asarray(jparams[layer][name]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,loss", [("gcn", "nll"), ("gin", "ce")])
def test_make_train_step_equals_train_node_classifier(ds, name, loss):
    """N steps of the public step are the N epochs of
    ``train_node_classifier`` with the same seed, exactly (dropout 0.5 for
    GCN; GIN's batch statistics)."""
    a = make(name, ds)
    res = pt.train_node_classifier(a, ds, epochs=3, seed=5, device="cpu")
    b = make(name, ds)
    step = make_train_step(b, adam(b), ds.graph, loss)
    gen = torch.Generator().manual_seed(5)
    out = [step(*tensors(ds), gen) for _ in range(3)]
    assert [float(lv) for lv, _ in out] == res.losses
    assert float(out[-1][1]) == res.train_acc
    for k, v in b.state_dict().items():
        assert torch.equal(v, res.params[k]), k


def test_make_train_step_returns_tensors_without_sync(ds):
    m = make("gcn", ds)
    lval, acc = make_train_step(m, adam(m), ds.graph)(*tensors(ds))
    assert lval.shape == () and acc.shape == () and not lval.requires_grad
    assert m.training


# ---------------------------------------------------------------------------
# the plain-torch baseline (pt1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,aggr", [("gcn", "sum"), ("sage", "max"),
                                        ("gin", "sum")])
def test_torch_baseline_matches_jax(ds, monkeypatch, model, aggr):
    """Same seed, same nets: the losses, TRG_ACC and TST_ACC of JAX's
    baseline at 1e-5 (its losses read through a recording loss)."""
    jds = jax_sbm_dataset(**SBM)
    seen = []

    def recording(base):
        class Recording(base):
            def forward(self, *a):
                out = super().forward(*a)
                seen.append(float(out.detach()))
                return out
        return Recording

    with monkeypatch.context() as mp:
        mp.setattr(torch.nn, "NLLLoss", recording(torch.nn.NLLLoss))
        mp.setattr(torch.nn, "CrossEntropyLoss",
                   recording(torch.nn.CrossEntropyLoss))
        want = jax_baseline(model, jds, epochs=4, hidden=16, aggr=aggr,
                            seed=7)
    got = train_torch_baseline(model, ds, epochs=4, hidden=16, aggr=aggr,
                               seed=7, device="cpu")
    np.testing.assert_allclose(got.losses, seen, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([got.train_acc, got.test_acc],
                               [want.train_acc, want.test_acc], rtol=1e-5)
    assert len(got.epoch_times) == 4 and "TRG_TM" in got.table()


def test_torch_baseline_leaves_the_global_generator(ds):
    state = torch.random.get_rng_state()
    train_torch_baseline("gcn", ds, epochs=1, hidden=8, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)


def test_run_model_pt1_prints_the_table(capsys):
    assert run_model.main(["gcn", "karate", "pt1", "--device", "cpu",
                           "--epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "Mode: pt1" in out and "TRG_TM\tTRG_STD\tTST_TM" in out
    assert len(out.strip().splitlines()[-2].split(",")) == 5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_with_adam_and_batch_stats(ds, tmp_path):
    m = make("gin", ds)
    opt = adam(m)
    step = make_train_step(m, opt, ds.graph, "ce")
    for _ in range(2):
        step(*tensors(ds))
    save_checkpoint(str(tmp_path), 2, m.state_dict(), opt.state_dict(),
                    extra={"epoch": 2})
    assert latest_step(str(tmp_path)) == 2
    ck = restore_checkpoint(str(tmp_path), device="cpu")
    assert set(ck) == {"params", "opt_state", "extra"}
    assert ck["extra"] == {"epoch": 2}
    assert any(k.endswith("bn1.mean") for k in ck["params"])
    for k, v in m.state_dict().items():
        assert torch.equal(ck["params"][k], v), k
    m2 = make("gin", ds)
    opt2 = adam(m2)
    m2.load_state_dict(ck["params"])
    opt2.load_state_dict(ck["opt_state"])
    for p, q in zip(opt.state.values(), opt2.state.values()):
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(p[f], q[f])


def test_checkpoint_keeps_the_newest_steps(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    for s in (1, 2, 10, 3, 11):
        save_checkpoint(d, s, {"w": torch.full((2,), float(s))},
                        max_to_keep=3)
    assert sorted(os.listdir(d)) == ["step_10.pt", "step_11.pt", "step_3.pt"]
    assert latest_step(d) == 11
    assert float(restore_checkpoint(d, device="cpu")["params"]["w"][0]) == 11
    assert float(restore_checkpoint(d, 3, device="cpu")["params"]["w"][0]) \
        == 3


def test_restore_raises_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), device="cpu")
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), step=2, device="cpu")


def test_restore_casts_to_a_template(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    ck = restore_checkpoint(str(tmp_path), device="cpu",
                            template={"params": {"w": torch.zeros(
                                3, dtype=torch.float64)}})
    assert ck["params"]["w"].dtype == torch.float64
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), device="cpu",
                           template={"params": {"v": torch.zeros(3)}})


def test_interrupted_run_equals_an_uninterrupted_one(ds, tmp_path):
    """3 steps, a checkpoint (parameters, Adam, the dropout generator), a
    fresh model and optimizer restored from it and 3 more steps give what 6
    steps in one go give, exactly."""
    whole = make("gcn", ds)
    step = make_train_step(whole, adam(whole), ds.graph)
    gen = torch.Generator().manual_seed(2)
    want = [float(step(*tensors(ds), gen)[0]) for _ in range(6)]

    first = make("gcn", ds)
    opt = adam(first)
    step = make_train_step(first, opt, ds.graph)
    gen = torch.Generator().manual_seed(2)
    got = [float(step(*tensors(ds), gen)[0]) for _ in range(3)]
    save_checkpoint(str(tmp_path), 3, first.state_dict(), opt.state_dict(),
                    extra={"generator": gen.get_state()})
    del first, opt, gen

    ck = restore_checkpoint(str(tmp_path), device="cpu")
    second = make("gcn", ds)
    opt = adam(second)
    second.load_state_dict(ck["params"])
    opt.load_state_dict(ck["opt_state"])
    gen = torch.Generator()
    gen.set_state(ck["extra"]["generator"])
    step = make_train_step(second, opt, ds.graph)
    got += [float(step(*tensors(ds), gen)[0]) for _ in range(3)]
    assert got == want
    for k, v in second.state_dict().items():
        assert torch.equal(v, whole.state_dict()[k]), k


def test_an_interrupted_save_leaves_no_partial_file(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4)})

    def failing(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", failing)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(4)})
    assert os.listdir(tmp_path) == ["step_1.pt"]
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 1
    assert torch.equal(restore_checkpoint(str(tmp_path), device="cpu")
                       ["params"]["w"], torch.ones(4))


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path, ds):
    with trace(str(tmp_path)) as d:
        pt.spmm(ds.graph, torch.ones(ds.num_nodes, 4))
    files = list(Path(d).glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "aten::" in files[0].read_text()


def test_timer_sums_sections_per_name():
    t = Timer()
    for _ in range(2):
        with t.section("a", sync=torch.zeros(1)):
            pass
    with t.section("b", sync=torch.device("cpu")):
        pass
    with pytest.raises(KeyError):
        with t.section("c"):
            raise KeyError("inside")
    assert set(t.sections) == {"a", "b", "c"}
    assert all(v >= 0.0 for v in t.sections.values())
    assert '"a"' in t.report()


def test_op_report_returns_seconds(ds):
    x0 = torch.ones(ds.num_nodes, 4)
    rep = op_report({"spmm": (lambda x: pt.spmm(ds.graph, x) * 1e-3, x0),
                     "relu": (torch.relu, x0)}, iters=3)
    assert set(rep) == {"spmm", "relu"} and all(v > 0 for v in rep.values())


# ---------------------------------------------------------------------------
# findbestk
# ---------------------------------------------------------------------------

def jax_findbestk():
    spec = importlib.util.spec_from_file_location(
        "jax_findbestk", ROOT / "scripts" / "findbestk.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,scale", [
    ("reddit-sim", 1e-4), (str(ROOT / "data" / "real" / "karate.mtx"), 1.0)])
def test_findbestk_graph_equals_jax_s(name, scale, monkeypatch):
    """JAX's numpy paths (no native library: the port has no native
    builder)."""
    from isplib_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    graph, arrays = findbestk.load_graph(name, scale, device="cpu")
    _, want = jax_findbestk()._load(name, scale)
    assert set(want) <= set(arrays)
    for f, w in want.items():
        if isinstance(w, np.ndarray):
            assert arrays[f].dtype == w.dtype, f
            np.testing.assert_array_equal(arrays[f], w, err_msg=f)
        else:
            assert arrays[f] == w, f
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(graph, f).numpy(), want[f])


def test_findbestk_tunes_once_per_k(monkeypatch, capsys):
    from isplib_tpu_torch.tune import autotune
    calls = []

    def fake_tune(graph, arrays, k, configs=None, iters=15, verbose=True):
        calls.append((k, configs, iters))
        return dict(backend="kernels", version=5, dense_threshold=64,
                    seconds=1e-3 * k, edges_per_s=graph.nnz / (1e-3 * k),
                    fill=0.5), None

    monkeypatch.setattr(autotune, "tune_spmm", fake_tune)
    mtx = str(ROOT / "data" / "real" / "karate.mtx")
    assert findbestk.main([mtx, "--ks", "8,16,41", "--iters", "2",
                           "--device", "cpu", "--extra",
                           '[{"version": 5, "dense_threshold": 256}]']) == 0
    assert [c[0] for c in calls] == [8, 16, 41]
    assert all(c[2] == 2 for c in calls)
    assert calls[0][1][-1] == {"version": 5, "dense_threshold": 256}
    assert len(calls[0][1]) == len(autotune.DEFAULT_CONFIGS) + 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["K", "backend"]
    assert [ln.split()[0] for ln in lines[1:4]] == ["8", "16", "41"]
    assert "dense_threshold=64" in lines[1]
    assert lines[-1].startswith("best K by edges/s: 8")


# ---------------------------------------------------------------------------
# the loaders' tiling=
# ---------------------------------------------------------------------------

def same_plan(p, q) -> None:
    assert type(p) is type(q)
    if dataclasses.is_dataclass(p):
        for f in dataclasses.fields(p):
            same_plan(getattr(p, f.name), getattr(q, f.name))
    elif isinstance(p, torch.Tensor):
        assert p.dtype == q.dtype
        if p.dtype == torch.bfloat16:  # bit for bit
            p, q = p.view(torch.int16), q.view(torch.int16)
        assert torch.equal(p, q)
    elif isinstance(p, (list, tuple)):
        assert len(p) == len(q)
        for a, b in zip(p, q):
            same_plan(a, b)
    else:
        assert p == q


@pytest.mark.parametrize("name,tiling", [
    ("karate", dict(version=2)),
    ("karate", dict(version=5, dense_threshold=64)),
    ("reddit-sim", dict(version=1, rb=128, ct=128, eb=128))])
def test_loaders_take_tiling(name, tiling):
    kw = dict(scale=1e-4, device="cpu")
    tiled = load(name, tiling=tiling, **kw)
    plain = load(name, **kw)
    assert isinstance(tiled.graph, TiledGraph)
    want = build_tiling(plain.graph, **tiling)
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(tiled.graph, f), getattr(want, f))
    np.testing.assert_array_equal(tiled.x, plain.x)


def test_load_mtx_takes_tiling():
    from isplib_tpu_torch.data import load_mtx
    ds = load_mtx(str(ROOT / "data" / "real" / "lesmis.mtx"), device="cpu",
                  tiling=dict(version=4))
    assert isinstance(ds.graph, TiledGraph)
    with pytest.raises(TypeError):
        load_mtx(str(ROOT / "data" / "real" / "lesmis.mtx"), device="cpu",
                 tiling=(256, 512, 512))
