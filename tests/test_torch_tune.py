"""The port's autotuner, tune cache, plan cache and ``auto_tile`` (on the
CPU the timings mean nothing, but the sweep, both caches and the decisions
must work), against the JAX package where it has the same function."""

import ast
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import isplib_tpu
from isplib_tpu.sparse.graph import _build_arrays as jax_build_arrays
from isplib_tpu.sparse.plan_cache import \
    graph_fingerprint as jax_graph_fingerprint
from isplib_tpu.tune import autotune as jax_autotune
import isplib_tpu_torch as pt
from isplib_tpu_torch.sparse import plan_cache, tiling
from isplib_tpu_torch.sparse.tiling import (PLAN_KEYS, TiledGraph,
                                            build_tiling_from_numpy,
                                            host_arrays)
from isplib_tpu_torch.tune import autotune

PORT = Path(pt.__file__).resolve().parent


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """A fresh tune cache and plan-cache directory."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setattr(autotune, "_CACHE_PATH", path)
    monkeypatch.setattr(autotune, "_memory_cache", None)
    plans = tmp_path / "plans"
    monkeypatch.setenv("ISPLIB_TPU_TORCH_CACHE_DIR", str(plans))
    return path, plans


def coo(seed, n=400, nnz=6000):
    """A dense corner (blocks above the thresholds) plus uniform edges."""
    rng = np.random.default_rng(seed)
    h = nnz // 2
    row = np.concatenate([rng.integers(0, 200, h), rng.integers(0, n, h)])
    col = np.concatenate([rng.integers(0, 200, h), rng.integers(0, n, h)])
    return row, col, rng.normal(size=nnz).astype(np.float32), n


def graph(seed=0, **kw):
    row, col, val, n = coo(seed, **kw)
    return pt.from_edge_index(np.stack([col, row]), num_nodes=n,
                              edge_value=val, edge_multiple=128,
                              device="cpu")


# ---------------------------------------------------------------------------
# signature, fingerprint, tune cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 32, 602])
@pytest.mark.parametrize("seed", [0, 1])
def test_signature_matches_jax(seed, k):
    row, col, val, n = coo(seed, n=300 + 50 * seed)
    ei = np.stack([col, row])
    g = pt.from_edge_index(ei, num_nodes=n, edge_value=val, device="cpu")
    jg = isplib_tpu.from_edge_index(ei, num_nodes=n, edge_value=val)
    assert autotune.signature_of(g, k) == jax_autotune.signature_of(jg, k)
    x = torch.zeros(n, k)
    assert autotune.graph_signature(g, x) == jax_autotune.graph_signature(
        jg, np.zeros((n, k), np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_fingerprint_matches_jax(seed):
    row, col, val, n = coo(seed)
    g = pt.from_edge_index(np.stack([col, row]), num_nodes=n,
                           edge_value=val, edge_multiple=128, device="cpu")
    jarrays = jax_build_arrays(row, col, val, n, n, 128)
    assert plan_cache.graph_fingerprint(host_arrays(g), g.nnz) == \
        jax_graph_fingerprint(jarrays, g.nnz)


@pytest.mark.parametrize("field", ["col", "value"])
def test_graph_fingerprint_sees_every_edge(field):
    """Above 131,072 edges the JAX package samples every other column and
    value; the port's hash changes with an edge that sample skips."""
    rng = np.random.default_rng(3)
    n, nnz = 2000, 140_000
    row = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    arrays = dict(rowptr=np.searchsorted(row, np.arange(n + 1)).astype(
                      np.int32),
                  row=row, col=rng.integers(0, n, nnz).astype(np.int32),
                  value=rng.normal(size=nnz).astype(np.float32))
    other = {f: a.copy() for f, a in arrays.items()}
    other[field][1] += 1  # index 1: outside JAX's stride-2 sample
    assert jax_graph_fingerprint(arrays, nnz) == \
        jax_graph_fingerprint(other, nnz)
    assert plan_cache.graph_fingerprint(arrays, nnz) != \
        plan_cache.graph_fingerprint(other, nnz)


def test_tune_cache_roundtrip(caches):
    path, _ = caches
    autotune.record("k1", {"backend": "kernels", "version": 2, "rb": 128})
    autotune._memory_cache = None  # force a re-read from disk
    assert autotune.lookup("k1") == {"backend": "kernels", "version": 2,
                                     "rb": 128}
    assert autotune.lookup("nope") is None
    assert json.loads(Path(path).read_text())["k1"]["version"] == 2
    assert not os.path.exists(path + ".tmp")


def test_tune_cache_corrupt_file_reads_empty(caches):
    path, _ = caches
    Path(path).write_text("{not json")
    assert autotune.lookup("k1") is None
    autotune.record("k1", {"backend": "reference"})
    autotune._memory_cache = None
    assert autotune.lookup("k1") == {"backend": "reference"}


# ---------------------------------------------------------------------------
# tune_spmm
# ---------------------------------------------------------------------------

ONE_PER_VERSION = [
    dict(version=5, dense_threshold=64),
    dict(version=4),
    dict(version=3, rb=128, ct=128, eb=128, dense_threshold=64, g=4),
    dict(version=2, rb=128, ct=128, eb=128),
    dict(version=1, rb=128, ct=128, eb=128),
]


def test_tune_spmm_records_a_winner(caches):
    path, plans = caches
    g = graph()
    best, tiled = autotune.tune_spmm(g, host_arrays(g), k=8,
                                     configs=ONE_PER_VERSION, iters=2,
                                     verbose=False)
    key = autotune.signature_of(g, 8)
    assert os.path.exists(path)
    autotune._memory_cache = None
    assert autotune.lookup(key) == best
    assert best["seconds"] > 0 and best["edges_per_s"] > 0
    if best["backend"] == "reference":
        assert tiled is None
    else:
        assert isinstance(tiled, TiledGraph) and tiled.bwd is not None
        assert any(plans.glob(f"plan_{key}_*.npz"))


def test_tune_spmm_without_reference_builds_the_winner(caches):
    """Only kernel configurations: the winner's full TiledGraph is built
    (with the transpose plan) through the plan cache; a config whose plan
    build rejects its keys is skipped."""
    _, plans = caches
    g = graph(1)
    bad = dict(version=1, dense_threshold=64)  # a foreign key: raises
    best, tiled = autotune.tune_spmm(g, None, k=16,
                                     configs=ONE_PER_VERSION[3:] + [bad],
                                     iters=2, include_reference=False,
                                     verbose=False)
    assert best["backend"] == "kernels" and best["version"] in (1, 2)
    assert 0 < best["fill"] <= 1
    assert isinstance(tiled, TiledGraph) and tiled.bwd is not None
    assert (tiled.fwd.rb, tiled.fwd.ct, tiled.fwd.eb) == (128, 128, 128)
    assert len(list(plans.glob("plan_*.npz"))) == 1
    x = torch.randn(g.num_cols, 16)
    np.testing.assert_allclose(pt.spmm(tiled, x).numpy(),
                               pt.spmm(g, x).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("include_reference", [True, False])
def test_tune_spmm_raises_when_a_kernel_fails(caches, monkeypatch,
                                              include_reference):
    """A kernel that fails to build or launch is no configuration to skip:
    the error propagates, and neither a winner nor a plan is recorded."""
    path, plans = caches
    from isplib_tpu_torch.kernels import spmm_hybrid

    def failing(plan, x):
        raise RuntimeError("spmm_rowblock launch failed: CUDA error 700")

    monkeypatch.setattr(spmm_hybrid, "spmm_rowblock", failing)
    g = graph()
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.tune_spmm(g, host_arrays(g), k=8, configs=ONE_PER_VERSION,
                           iters=2, include_reference=include_reference,
                           verbose=False)
    assert not os.path.exists(path)
    assert autotune.lookup(autotune.signature_of(g, 8)) is None
    assert not any(plans.glob("*.npz"))


def test_tune_spmm_times_prebuilt_tilings(caches, monkeypatch):
    """``built`` TiledGraphs are timed as they are, and the winner's plans
    are persisted from its build, where ``auto_tile``'s lookup finds them:
    nothing is built inside the sweep."""
    _, plans = caches
    g = graph()
    arrays = host_arrays(g)
    built = [build_tiling_from_numpy(g, arrays, k=8, **c)
             for c in ONE_PER_VERSION]

    def no_build(*args, **kw):
        raise AssertionError("a plan was built in the sweep")

    monkeypatch.setattr(tiling, "_build_fn", no_build)
    monkeypatch.setattr(tiling, "build_minmax_plan", no_build)
    with pytest.raises(ValueError, match="2 TiledGraphs for 5"):
        autotune.tune_spmm(g, arrays, k=8, configs=ONE_PER_VERSION,
                           built=built[:2], verbose=False)
    best, tiled = autotune.tune_spmm(g, arrays, k=8, configs=ONE_PER_VERSION,
                                     iters=2, include_reference=False,
                                     verbose=False, built=built)
    i = next(i for i, c in enumerate(ONE_PER_VERSION)
             if all(best.get(f) == v for f, v in c.items()))
    assert tiled is built[i]
    key = autotune.signature_of(g, 8)
    assert len(list(plans.glob(f"plan_{key}_*.npz"))) == 1
    version = best["version"]
    cfg = {f: best[f] for f in PLAN_KEYS[version] if f in best}
    loaded = build_tiling_from_numpy(g, arrays, version=version, k=8,
                                     cache_tag=key, **cfg)
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(loaded, f), getattr(tiled, f))


def test_default_configs_are_jax_s_reduced():
    """Every JAX configuration, reduced to the port's keys, is one of the
    port's, and every port configuration takes only its version's keys."""
    ours = [tuple(sorted(c.items())) for c in autotune.DEFAULT_CONFIGS]
    assert len(set(ours)) == len(ours) == 9
    for cfg in jax_autotune.DEFAULT_CONFIGS:
        v = cfg["version"]
        reduced = {f: x for f, x in cfg.items() if f in PLAN_KEYS[v]}
        assert tuple(sorted({"version": v, **reduced}.items())) in ours
    for cfg in autotune.DEFAULT_CONFIGS:
        assert set(cfg) - {"version"} <= set(PLAN_KEYS[cfg["version"]])


# ---------------------------------------------------------------------------
# auto_tile
# ---------------------------------------------------------------------------

@pytest.fixture()
def tileable(monkeypatch, caches):
    """auto_tile on CPU graphs of a few thousand edges."""
    monkeypatch.setattr(tiling, "AUTO_TILE_MIN_NNZ", 100)
    monkeypatch.setattr(tiling, "_on_cuda", lambda g: True)
    return caches


def test_auto_tile_leaves_small_and_cpu_graphs():
    g = graph()
    assert tiling.auto_tile(g, k=32) is g


@pytest.mark.parametrize("version", [1, 2, 3])
def test_auto_tile_takes_the_tuned_config(tileable, version):
    g = graph()
    cfg = dict(version=version, rb=128, ct=128, eb=128)
    if version == 3:
        cfg.update(dense_threshold=64, g=4)
    autotune.record(autotune.signature_of(g, 32),
                    dict(backend="kernels", seconds=1.0, **cfg))
    tiled = tiling.auto_tile(g, k=32)
    assert isinstance(tiled, TiledGraph)
    assert type(tiled.fwd) is type(build_tiling_from_numpy(
        g, host_arrays(g), k=32, **cfg).fwd)
    assert tiled.bwd is not None
    assert tiling.auto_tile(g, k=32) is tiled  # memoized
    assert tiling.auto_tile(g, k=20) is tiled  # the same K bucket


def test_auto_tile_leaves_the_graph_on_a_reference_entry(tileable):
    g = graph()
    autotune.record(autotune.signature_of(g, 32),
                    dict(backend="reference", seconds=1.0))
    assert tiling.auto_tile(g, k=32) is g


def test_auto_tile_without_entry_takes_the_occupancy_rule(tileable):
    """The untuned v5 build is not cached: it writes no plan file."""
    _, plans = tileable
    g = graph()
    tiled = tiling.auto_tile(g, k=32)
    occ = g.nnz / 16  # 4 x 4 blocks of 128
    assert tiled.fwd.dense_threshold == (64 if occ >= 200 else 128)
    assert not any(plans.glob("*.npz"))


@pytest.mark.parametrize("version", [None, 1, 2])
def test_auto_tile_shares_plans_that_do_not_depend_on_k(tileable,
                                                        monkeypatch,
                                                        version):
    """A two-layer GCN's K buckets (32 and 41) take one build of the plans
    that do not depend on k (the untuned version 5, or version 1) and one
    build per bucket of version 2, which sizes its plans by k."""
    g = graph()
    if version is not None:
        for k in (32, 41):
            autotune.record(autotune.signature_of(g, k), dict(
                backend="kernels", version=version, rb=128, ct=128, eb=128,
                seconds=1.0))
    builds = []
    build = tiling.build_tiling
    monkeypatch.setattr(tiling, "build_tiling",
                        lambda *a, **kw: builds.append(kw["k"])
                        or build(*a, **kw))
    first = tiling.auto_tile(g, k=32)
    second = tiling.auto_tile(g, k=41)
    if version == 2:
        assert builds == [32, 41] and second.fwd is not first.fwd
    else:
        assert builds == [32] and second is first
    assert tiling.auto_tile(g, k=41) is second
    assert len(builds) == (2 if version == 2 else 1)


def test_auto_tile_memo_lets_the_graph_go(tileable):
    """The memo holds the plans, not the graph: once the graph and its
    TiledGraph are dropped, the entry goes and a new TiledGraph of the
    memoised plans is made while the graph lives."""
    import gc
    import weakref

    g = graph()
    tiled = tiling.auto_tile(g, k=32)
    plans = tiled.fwd
    del tiled
    gc.collect()
    again = tiling.auto_tile(g, k=32)
    assert again.fwd is plans and again.graph is g
    key, alive = id(g), weakref.ref(g)
    del g, again
    gc.collect()
    assert alive() is None and key not in tiling._AUTO_TILED


def test_auto_tile_loads_plans_from_the_plan_cache(tileable, monkeypatch):
    """A fresh graph of the same arrays takes the plans that the first
    build persisted: nothing is built again."""
    g = graph()
    autotune.record(autotune.signature_of(g, 32), dict(
        backend="kernels", version=1, rb=128, ct=128, eb=128, seconds=1.0))
    first = tiling.auto_tile(g, k=32)

    def no_build(*args, **kw):
        raise AssertionError("a plan was built again")

    monkeypatch.setattr(tiling, "_build_fn", no_build)
    monkeypatch.setattr(tiling, "build_minmax_plan", no_build)
    again = tiling.auto_tile(graph(), k=32)
    assert again is not first
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(again, f), getattr(first, f))


def test_tuned_winner_at_the_feature_width_trains_on_its_plans(tileable,
                                                              monkeypatch):
    """``tune_spmm`` records its winner at a dataset's feature width;
    ``train_node_classifier``, which auto-tiles at that width, then trains
    on that configuration's plans, loaded from the plan cache (nothing is
    built again), and its SpMMs run that version's kernel."""
    from isplib_tpu_torch import GCN, train_node_classifier
    from isplib_tpu_torch.data import NodeDataset
    from isplib_tpu_torch.kernels import spmm_hybrid

    feats = 24
    g = graph()
    best, tiled = autotune.tune_spmm(
        g, host_arrays(g), k=feats, configs=[ONE_PER_VERSION[4]], iters=2,
        include_reference=False, verbose=False)
    assert best["backend"] == "kernels" and best["version"] == 1
    assert autotune.lookup(autotune.signature_of(g, feats)) == best

    def no_build(*args, **kw):
        raise AssertionError("a plan was built again")

    monkeypatch.setattr(tiling, "_build_fn", no_build)
    monkeypatch.setattr(tiling, "build_minmax_plan", no_build)
    ran = []

    def counting(plan, x, run=spmm_hybrid.spmm_rowblock):
        ran.append(plan)
        return run(plan, x)

    monkeypatch.setattr(spmm_hybrid, "spmm_rowblock", counting)
    rng = np.random.default_rng(0)
    fresh = graph()  # the same arrays, a new graph: auto_tile's memo misses
    n = fresh.num_rows
    mask = np.ones(n, bool)
    ds = NodeDataset(name="tuned", graph=fresh,
                     x=rng.normal(size=(n, feats)).astype(np.float32),
                     y=rng.integers(0, 3, n).astype(np.int32),
                     train_mask=mask, val_mask=mask, test_mask=mask,
                     num_classes=3)
    model = GCN(feats, hidden=8, num_classes=3, seed=0, device="cpu")
    res = train_node_classifier(model, ds, epochs=2, device="cpu")
    assert np.all(np.isfinite(res.losses))
    assert ran  # forward over A and grad_x over Aᵀ, every epoch
    for plan in ran:
        assert (plan.rb, plan.ct, plan.eb) == (128, 128, 128)
    same_plan(ran[0], tiled.fwd)
    assert any(p.num_rows == tiled.bwd.num_rows and torch.equal(
        p.edges, tiled.bwd.edges) for p in ran[1:])


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def same_plan(p, q) -> None:
    assert type(p) is type(q)
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(q, f.name)
        if dataclasses.is_dataclass(a):
            same_plan(a, b)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            if a.dtype == torch.bfloat16:  # bit for bit
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("cfg", ONE_PER_VERSION,
                         ids=lambda c: f"v{c['version']}")
def test_plan_cache_roundtrip_keeps_dtypes(cfg, tmp_path, monkeypatch):
    g = graph()
    arrays = host_arrays(g)
    built = build_tiling_from_numpy(g, arrays, k=32, cache_tag="t",
                                    cache_dir=str(tmp_path), **cfg)
    assert len(list(tmp_path.glob("plan_t_*.npz"))) == 1
    monkeypatch.setattr(tiling, "_build_fn", lambda *a: (
        lambda *b: pytest.fail("rebuilt")))
    loaded = build_tiling_from_numpy(g, arrays, k=32, cache_tag="t",
                                     cache_dir=str(tmp_path), **cfg)
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(loaded, f), getattr(built, f))
    if cfg["version"] in (3, 5):
        blocks = (loaded.fwd.bsr.blocks if cfg["version"] == 3
                  else loaded.fwd.blocks)
        assert blocks.dtype == torch.bfloat16 and blocks.numel() > 0


@pytest.mark.parametrize("cfg", [ONE_PER_VERSION[4], ONE_PER_VERSION[2],
                                 ONE_PER_VERSION[0], ONE_PER_VERSION[3]],
                         ids=["v1", "v3", "v5", "v2"])
def test_plan_cache_keeps_the_schedules(cfg, tmp_path, monkeypatch):
    """The v1, v3, v5 and v2 plans carry K10's, K9's, K2's and K8's
    schedules (the v3 plan's residual K8's too), and ``fwd_mm`` K3's; the
    cache stores and loads them under format 4, and an entry written under
    format 3 (max/min plans without schedules) is missed, never read."""
    assert plan_cache.PLAN_FORMAT_VERSION == 4
    g = graph()
    arrays = host_arrays(g)

    def scheds(plan):
        if cfg["version"] == 3:
            return [plan.bsr.sched, plan.residual.sched]
        return [plan.sched]

    monkeypatch.setattr(plan_cache, "PLAN_FORMAT_VERSION", 3)
    build_tiling_from_numpy(g, arrays, k=32, cache_tag="s",
                            cache_dir=str(tmp_path), **cfg)
    monkeypatch.setattr(plan_cache, "PLAN_FORMAT_VERSION", 4)
    built = build_tiling_from_numpy(g, arrays, k=32, cache_tag="s",
                                    cache_dir=str(tmp_path), **cfg)
    assert len(list(tmp_path.glob("plan_s_*.npz"))) == 2
    monkeypatch.setattr(tiling, "_build_fn", lambda *a: (
        lambda *b: pytest.fail("rebuilt")))
    loaded = build_tiling_from_numpy(g, arrays, k=32, cache_tag="s",
                                     cache_dir=str(tmp_path), **cfg)
    for f in ("fwd", "bwd"):
        for got, want in zip(scheds(getattr(loaded, f)),
                             scheds(getattr(built, f))):
            assert got is not None
            same_plan(got, want)
    assert loaded.fwd_mm.sched is not None
    same_plan(loaded.fwd_mm.sched, built.fwd_mm.sched)


@pytest.mark.parametrize("marked", [True, False],
                         ids=["fmt-2", "no-fmt"])
def test_plan_cache_format_2_file_is_a_logged_miss(marked, tmp_path,
                                                    monkeypatch, capsys):
    """A format-2 entry at the path a format-4 build looks up (one saved
    under format 2, or one written before files carried their format) is
    a logged miss: the plans are rebuilt, with their schedules, and the
    entry is replaced."""
    g = graph()
    arrays = host_arrays(g)
    cfg = dict(ONE_PER_VERSION[0])
    built = build_tiling_from_numpy(g, arrays, k=32, cache_tag="f",
                                    cache_dir=str(tmp_path), **cfg)
    (path,) = tmp_path.glob("plan_f_*.npz")
    old = dict(fwd=dataclasses.replace(built.fwd, sched=None),
               bwd=dataclasses.replace(built.bwd, sched=None),
               fwd_mm=built.fwd_mm, bwd_mm=built.bwd_mm)
    if marked:
        monkeypatch.setattr(plan_cache, "PLAN_FORMAT_VERSION", 2)
        plan_cache.save_host_plans(str(path), old)
        monkeypatch.setattr(plan_cache, "PLAN_FORMAT_VERSION", 4)
    else:
        arrays_out: list = []
        spec = json.dumps(plan_cache._encode(old, arrays_out)).encode()
        np.savez(path, spec=np.frombuffer(spec, np.uint8),
                 **{f"a{i}": a for i, a in enumerate(arrays_out)})
    capsys.readouterr()
    assert plan_cache.load_host_plans(str(path)) is None
    assert "is format 2, not 4; rebuilding" in capsys.readouterr().err
    rebuilt = build_tiling_from_numpy(g, arrays, k=32, cache_tag="f",
                                      cache_dir=str(tmp_path), **cfg)
    assert "is format 2, not 4" in capsys.readouterr().err
    for f in ("fwd", "bwd"):
        same_plan(getattr(rebuilt, f).sched, getattr(built, f).sched)
    loaded = plan_cache.load_host_plans(str(path))
    assert loaded is not None and loaded["fwd"].sched is not None


def test_plan_cache_keys_differ_for_different_edges(tmp_path):
    """Two graphs of equal sizes but different edges never share plans."""
    a, b = graph(0), graph(7)
    assert (a.num_rows, a.nnz) == (b.num_rows, b.nnz)
    build_tiling_from_numpy(a, host_arrays(a), version=2, cache_tag="same",
                            cache_dir=str(tmp_path))
    build_tiling_from_numpy(b, host_arrays(b), version=2, cache_tag="same",
                            cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("plan_same_*.npz"))) == 2


@dataclasses.dataclass
class Foreign:
    a: int = 1


def test_plan_cache_refuses_a_foreign_dataclass(tmp_path):
    with pytest.raises(TypeError, match="refuses"):
        plan_cache.save_host_plans(str(tmp_path / "p.npz"), {"x": Foreign()})
    # a spec that names a class outside the port decodes as a logged miss
    path = tmp_path / "q.npz"
    spec = json.dumps({"t": "dc", "cls": "os.path:join", "v": {}}).encode()
    np.savez(path, spec=np.frombuffer(spec, np.uint8),
             fmt=np.int32(plan_cache.PLAN_FORMAT_VERSION))
    assert plan_cache.load_host_plans(str(path)) is None


def test_plan_cache_corrupt_entry_is_a_logged_miss(tmp_path, capsys):
    path = tmp_path / "plan_x.npz"
    path.write_bytes(b"not an npz")
    assert plan_cache.load_host_plans(str(path)) is None
    assert "failed to decode" in capsys.readouterr().err
    assert plan_cache.load_host_plans(str(tmp_path / "missing.npz")) is None


def test_plan_cache_dir_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("ISPLIB_TPU_TORCH_CACHE_DIR", str(tmp_path / "c"))
    assert plan_cache.default_cache_dir() == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()
    monkeypatch.delenv("ISPLIB_TPU_TORCH_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert plan_cache.default_cache_dir() == str(
        tmp_path / ".cache" / "isplib_tpu_torch")


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def _docstrings(tree) -> set:
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def test_port_imports_no_jax():
    """No module of the port, and not ``chip_smoke.py`` (which drives the
    port on a card without JAX), imports JAX, flax or the JAX package; its
    strings may name JAX files.  None reaches the JAX package's native
    library either: no text names ``libisplib_graph.so`` or
    ``isplib_tpu.native``, no string in the code names the repo's
    ``native/`` directory, and no relative import leaves the port."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    assert PORT / "interop" / "torch_bridge.py" in files
    assert PORT / "native" / "__init__.py" in files
    for f in ("bench.py", "bench_fused.py", "utils/roofline.py",
              "run_all.py"):
        assert PORT / f in files
    files.append(PORT.parent / "chip_smoke.py")
    for f in files:
        text = f.read_text()
        where = f.relative_to(PORT.parent)
        for banned in ("libisplib_graph", "isplib_tpu.native"):
            assert banned not in text, f"{where} names {banned}"
        tree = ast.parse(text)
        docs = _docstrings(tree)
        package = list(f.relative_to(PORT.parent).parent.parts)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                parts = node.value.replace("\\", "/").split("/")
                assert "native" not in parts or f.parent.name == "native", (
                    f"{where} names a native/ path: {node.value!r}")
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.ImportFrom):
                assert f.name != "chip_smoke.py" and node.level <= len(
                    package), f"{where}: a relative import leaves the port"
                continue
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "isplib_tpu"), (
                    f"{where} imports {name}")
