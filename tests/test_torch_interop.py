"""The port's torch/PyG bridge (``isplib_tpu_torch.interop``) against the
JAX package's bridge and a dense oracle, the patch surface on fake
``torch_sparse`` / ``torch_geometric`` modules, the process-default
backend, and ``spmm``'s auto-tiling of a large plain graph (CPU graphs are
faked to be on CUDA and the size threshold lowered, as
``test_torch_tune.py`` does)."""

import gc
import importlib
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from isplib_tpu.interop import clear_cache as jax_clear_cache
from isplib_tpu.interop import iSpLibPlugin as JaxPlugin
from isplib_tpu.interop import torch_spmm as jax_torch_spmm
import isplib_tpu_torch as pt
from isplib_tpu_torch.interop import (clear_cache, iSpLibPlugin,
                                      isplib_autotune, spmm_autotuned,
                                      torch_bridge, torch_spmm)
from isplib_tpu_torch.sparse import tiling
from isplib_tpu_torch.sparse.tiling import TiledGraph
from isplib_tpu_torch.tune import autotune

# the module (the package's ``spmm`` attribute is the function)
spmm_mod = importlib.import_module("isplib_tpu_torch.ops.spmm")

R, C, K = 48, 40, 8


def random_csr(seed=0):
    """As ``tests/test_interop.py``: ~15% density, every row non-empty,
    normal values (so max/min have no ties)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((R, C)) < 0.15).astype(np.float32)
    dense[np.arange(R), rng.integers(0, C, R)] = 1.0
    a = dense * rng.normal(size=(R, C)).astype(np.float32)
    return sp.csr_matrix(a), a


class FakeSparseTensor:
    """A ``torch_sparse.SparseTensor`` as the bridge sees it."""

    def __init__(self, rowptr, col, value, sizes):
        self.rowptr, self.col, self.value, self.sizes = (rowptr, col, value,
                                                         sizes)

    def csr(self):
        return self.rowptr, self.col, self.value

    def sparse_sizes(self):
        return self.sizes


def container(kind, mat):
    rowptr = torch.from_numpy(mat.indptr.astype(np.int64))
    col = torch.from_numpy(mat.indices.astype(np.int64))
    val = torch.from_numpy(mat.data.astype(np.float32))
    if kind == "csr":
        return torch.sparse_csr_tensor(rowptr, col, val, size=mat.shape)
    if kind == "coo":
        c = mat.tocoo()
        return torch.sparse_coo_tensor(
            np.stack([c.row, c.col]).astype(np.int64),
            c.data.astype(np.float32), size=mat.shape)
    return FakeSparseTensor(rowptr, col, val, mat.shape)


def dense_oracle(a, x, reduce):
    at, mask = torch.from_numpy(a), torch.from_numpy(a != 0)
    if reduce == "sum":
        return at @ x
    if reduce == "mean":
        return (at @ x) / mask.sum(1, keepdim=True).clamp(min=1).float()
    big = torch.where(mask[:, :, None], at[:, :, None] * x[None],
                      torch.tensor(-np.inf if reduce == "max" else np.inf))
    return big.amax(1) if reduce == "max" else big.amin(1)


@pytest.fixture(autouse=True)
def fresh():
    """Empty bridge caches, nothing patched and the default backend, before
    and after every test."""
    clear_cache()
    jax_clear_cache()
    previous = pt.set_default_backend("auto")
    try:
        yield
    finally:
        iSpLibPlugin.unpatch_pyg()
        JaxPlugin.unpatch_pyg()
        clear_cache()
        jax_clear_cache()
        pt.set_default_backend(previous)


@pytest.fixture()
def tileable(monkeypatch, tmp_path):
    """auto_tile on CPU graphs of a few hundred edges, fresh caches, and a
    count of the plan builds."""
    monkeypatch.setattr(tiling, "AUTO_TILE_MIN_NNZ", 100)
    monkeypatch.setattr(tiling, "_on_cuda", lambda g: True)
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "tune.json"))
    monkeypatch.setattr(autotune, "_memory_cache", None)
    monkeypatch.setenv("ISPLIB_TPU_TORCH_CACHE_DIR", str(tmp_path / "plans"))
    builds = []
    build = tiling.build_tiling

    def counting(g, **kw):
        builds.append(g)
        return build(g, **kw)

    monkeypatch.setattr(tiling, "build_tiling", counting)
    return builds


# ---------------------------------------------------------------------------
# torch_spmm against the JAX bridge and the dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["csr", "coo", "sparse_tensor"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_torch_spmm_matches_jax_bridge(kind, reduce):
    mat, a = random_csr(seed=2)
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(C, K)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    outs, grads = [], []
    for fn in (torch_spmm, jax_torch_spmm):
        x = torch.tensor(xv, requires_grad=True)
        out = fn(container(kind, mat), x, reduce=reduce)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append(x.grad)
    x = torch.tensor(xv, requires_grad=True)
    want = dense_oracle(a, x, reduce)
    (want * w).sum().backward()
    assert outs[0].shape == (R, K) and outs[0].dtype == torch.float32
    if reduce in ("max", "min"):
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(grads[0], grads[1])
    else:
        torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
    for out, grad in zip(outs, grads):  # both bridges, the dense oracle
        torch.testing.assert_close(out, want.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grad, x.grad, rtol=1e-5, atol=1e-5)


def test_implicit_values_are_one():
    mat, a = random_csr(seed=4)
    st = container("sparse_tensor", mat)
    st.value = None
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(C, K)).astype(np.float32))
    torch.testing.assert_close(torch_spmm(st, x),
                               dense_oracle((a != 0).astype(np.float32), x,
                                            "sum"), rtol=1e-5, atol=1e-5)


def test_reduce_aliases_and_spmm_autotuned():
    mat, a = random_csr(seed=7)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(C, K)).astype(np.float32))
    out = spmm_autotuned(container("csr", mat), x, reduce="add")
    torch.testing.assert_close(out, dense_oracle(a, x, "sum"), rtol=1e-5,
                               atol=1e-5)


def test_edge_values_get_no_gradient():
    mat, a = random_csr(seed=9)
    src = container("csr", mat)
    src.values().requires_grad_(True)
    x = torch.ones(C, K, requires_grad=True)
    torch_spmm(src, x).sum().backward()
    assert x.grad is not None and src.values().grad is None


# ---------------------------------------------------------------------------
# the graph cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["csr", "coo", "sparse_tensor"])
def test_graph_cache_builds_once_and_holds_its_tensors(kind, monkeypatch):
    builds, copies = [], []
    build, host = torch_bridge.from_scipy, torch_bridge._host
    monkeypatch.setattr(torch_bridge, "from_scipy",
                        lambda *a, **kw: builds.append(1) or build(*a, **kw))
    monkeypatch.setattr(torch_bridge, "_host",
                        lambda *a: copies.append(1) or host(*a))
    mat, a = random_csr(seed=1)
    src = container(kind, mat)
    x = torch.randn(C, K)
    first = torch_spmm(src, x)
    n_copies = len(copies)
    assert builds == [1] and n_copies == 3
    for reduce in ("sum", "mean", "max"):
        torch_spmm(src, x, reduce=reduce)
    assert builds == [1] and len(copies) == n_copies  # no host copy
    (graph, held), = torch_bridge._graph_cache.values()
    keyed = torch_bridge._parts(src)[0]
    assert [t.data_ptr() for t in held] == [t.data_ptr() for t in keyed]
    assert torch.equal(torch_spmm(src, x), first)
    # a second adjacency with the same values is a second entry
    torch_spmm(container(kind, mat), x)
    assert builds == [1, 1] and len(torch_bridge._graph_cache) == 2
    clear_cache()
    assert not torch_bridge._graph_cache
    torch_spmm(src, x)
    assert builds == [1, 1, 1]


def test_mismatched_devices_raise():
    mat, _ = random_csr()
    with pytest.raises(ValueError, match="different|move"):
        torch_spmm(container("csr", mat), torch.empty(C, K, device="meta"))
    assert not torch_bridge._graph_cache


def test_unsupported_operand_raises():
    with pytest.raises(TypeError):
        torch_spmm(torch.zeros(R, C), torch.zeros(C, K))


# ---------------------------------------------------------------------------
# patch_pyg / unpatch_pyg / isplib_autotune
# ---------------------------------------------------------------------------

@pytest.fixture()
def fake_pyg(monkeypatch):
    """Fake ``torch_sparse`` (``matmul``) and ``torch_geometric.typing``
    (``WITH_PT2``, ``WITH_PT20``) modules."""

    def matmul(src, other, reduce="sum"):
        raise AssertionError("the unpatched torch_sparse.matmul ran")

    ts = types.ModuleType("torch_sparse")
    ts.matmul = matmul
    pyg = types.ModuleType("torch_geometric")
    typing = types.ModuleType("torch_geometric.typing")
    typing.WITH_PT2, typing.WITH_PT20 = True, True
    pyg.typing = typing
    monkeypatch.setitem(sys.modules, "torch_sparse", ts)
    monkeypatch.setitem(sys.modules, "torch_geometric", pyg)
    monkeypatch.setitem(sys.modules, "torch_geometric.typing", typing)
    return ts, typing, matmul


def test_patch_pyg_patches_and_restores(fake_pyg):
    ts, typing, matmul = fake_pyg
    orig_mm = torch.sparse.mm
    iSpLibPlugin.patch_pyg()
    try:
        assert torch.sparse.mm is not orig_mm
        assert ts.matmul is spmm_autotuned
        assert typing.WITH_PT2 is False and typing.WITH_PT20 is False
        assert len(iSpLibPlugin.backup) == 4
        iSpLibPlugin.patch_pyg()  # idempotent
        assert len(iSpLibPlugin.backup) == 4
        mat, a = random_csr(seed=5)
        x = torch.from_numpy(np.random.default_rng(6).normal(
            size=(C, K)).astype(np.float32))
        torch.testing.assert_close(
            torch.sparse.mm(container("coo", mat), x),
            dense_oracle(a, x, "sum"), rtol=1e-5, atol=1e-5)
        st = container("sparse_tensor", mat)
        assert torch.equal(ts.matmul(st, x, reduce="max"),
                           torch_spmm(st, x, "max"))
    finally:
        iSpLibPlugin.unpatch_pyg()
    assert torch.sparse.mm is orig_mm
    assert ts.matmul is matmul
    assert typing.WITH_PT2 is True and typing.WITH_PT20 is True
    assert iSpLibPlugin.backup == []


def test_patch_pyg_without_torch_sparse_patches_torch_only(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch_sparse", None)  # ImportError
    monkeypatch.setitem(sys.modules, "torch_geometric", None)
    iSpLibPlugin.patch_pyg()
    assert [(o, n) for o, n, _ in iSpLibPlugin.backup] == [
        (torch.sparse, "mm")]


def test_patch_pyg_rejects_jax_backends_and_tuple_tiling():
    for name in ("xla", "pallas"):
        with pytest.raises(ValueError):
            iSpLibPlugin.patch_pyg(backend=name)
    with pytest.raises(TypeError):
        iSpLibPlugin.patch_pyg(tiling=(256, 512, 512))
    assert iSpLibPlugin.backup == []


def test_isplib_autotune_restores_when_the_body_raises(fake_pyg):
    ts, _, matmul = fake_pyg
    orig_mm = torch.sparse.mm
    seen = {}

    @isplib_autotune
    def body():
        seen["patched"] = (torch.sparse.mm is not orig_mm
                           and ts.matmul is spmm_autotuned)
        raise KeyError("inside")

    with pytest.raises(KeyError):
        body()
    assert seen["patched"]
    assert torch.sparse.mm is orig_mm and ts.matmul is matmul
    assert iSpLibPlugin.backup == []


def test_patch_pyg_tiling_builds_plans():
    mat, a = random_csr(seed=11)
    iSpLibPlugin.patch_pyg(tiling=dict(version=2, rb=128, ct=128, eb=128))
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(C, K)).astype(np.float32))
    out = torch.sparse.mm(container("csr", mat), x)
    (graph, _), = torch_bridge._graph_cache.values()
    assert isinstance(graph, TiledGraph)
    assert (graph.fwd.rb, graph.fwd.ct, graph.fwd.eb) == (128, 128, 128)
    torch.testing.assert_close(out, dense_oracle(a, x, "sum"), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("default", ["auto", "reference"])
def test_patch_pyg_backend_none_takes_the_default(tileable, default):
    """``patch_pyg()`` (backend None) runs the bridged calls on the process
    default: ``auto`` tiles the (large enough) graph, ``reference`` does
    not; the JAX bridge's default would be its plain path."""
    mat, a = random_csr(seed=13)
    pt.set_default_backend(default)
    iSpLibPlugin.patch_pyg()
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(C, K)).astype(np.float32))
    out = torch.sparse.mm(container("csr", mat), x)
    assert len(tileable) == (1 if default == "auto" else 0)
    torch.testing.assert_close(out, dense_oracle(a, x, "sum"), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# set_default_backend and spmm's auto-tiling
# ---------------------------------------------------------------------------

def test_set_default_backend_takes_the_port_s_names():
    assert pt.set_default_backend("reference") == "auto"
    assert spmm_mod._default_backend == "reference"
    assert pt.set_default_backend("auto") == "reference"
    for name in ("xla", "pallas", "kernels"):
        with pytest.raises(ValueError):
            pt.set_default_backend(name)
    assert spmm_mod._default_backend == "auto"
    assert not hasattr(pt.ops, "using_backend")


def sparse_graph(seed=0, n=1000, nnz=2000):
    """~31 edges per 128x128 block: every edge is residual (K1's plain
    version, fp32), so the tiled path holds the reference at 1e-5."""
    rng = np.random.default_rng(seed)
    return pt.from_edge_index(
        np.stack([rng.integers(0, n, nnz), rng.integers(0, n, nnz)]),
        num_nodes=n, edge_value=rng.normal(size=nnz).astype(np.float32),
        edge_multiple=128, device="cpu")


def test_spmm_auto_tiles_a_large_csr_graph_once(tileable):
    g = sparse_graph()
    x = torch.randn(g.num_cols, K, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    want = pt.spmm(g, x, backend="reference")
    for _ in range(3):
        got = pt.spmm(g, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert tileable == [g]
    tiled = tiling.auto_tile(g, k=K)
    assert isinstance(tiled, TiledGraph) and tiled.fwd.nb == 0
    gx, = torch.autograd.grad(got.sum(), x)
    gx_ref, = torch.autograd.grad(want.sum(), x)
    torch.testing.assert_close(gx, gx_ref, rtol=1e-5, atol=1e-5)
    for reduce in ("max", "min"):
        assert torch.equal(pt.spmm(g, x, reduce),
                           pt.spmm(g, x, reduce, backend="reference"))
    assert tileable == [g]  # one tiling serves every reduction


def test_spmm_reference_backend_never_tiles(tileable):
    g = sparse_graph()
    x = torch.randn(g.num_cols, K)
    pt.spmm(g, x, backend="reference")
    model = pt.GCN(K, 8, 3, device="cpu")
    model(g, x, backend="reference")
    pt.GIN(K, 8, 3, device="cpu")(g, x, backend="reference")
    pt.set_default_backend("reference")
    model(g, x)
    pt.spmm(g, x, "max")
    assert tileable == []


def test_train_without_tile_never_tiles(tileable):
    from isplib_tpu_torch.data import NodeDataset
    g = sparse_graph(n=600, nnz=1500)
    rng = np.random.default_rng(0)
    n = g.num_rows
    ds = NodeDataset("sparse", g, rng.normal(size=(n, 16)).astype(np.float32),
                     rng.integers(0, 3, n).astype(np.int32),
                     *(np.ones(n, bool),) * 3, num_classes=3)
    res = pt.train_node_classifier(
        pt.GCN(16, 8, 3, device="cpu"), ds, epochs=2, device="cpu",
        tile=False)
    assert np.all(np.isfinite(res.losses)) and tileable == []
    assert spmm_mod._default_backend == "auto"


def test_spmm_of_values_that_need_a_gradient_is_not_tiled(tileable):
    """``spmm(g.with_value(v), x)`` with ``v`` requiring a gradient (the
    attention pattern) runs the reference path with no build: forward,
    ``grad_x`` and ``grad_v`` equal ``backend="reference"``."""
    g = sparse_graph(seed=3)
    gen = torch.Generator().manual_seed(1)
    v0 = torch.randn(g.nnz_padded, generator=gen)
    x0 = torch.randn(g.num_cols, K, generator=gen)
    w = torch.randn(g.num_rows, K, generator=gen)
    for reduce in ("sum", "mean", "max"):
        got = []
        for backend in ("auto", "reference"):
            v = v0.clone().requires_grad_(True)
            x = x0.clone().requires_grad_(True)
            out = pt.spmm(g.with_value(v), x, reduce, backend=backend)
            (out * w).sum().backward()
            got.append((out.detach(), x.grad, v.grad))
        for a, b in zip(*got):
            assert torch.equal(a, b)
    assert tileable == []


def test_bridge_cache_is_bounded_when_values_are_new_each_call(tileable):
    """A fresh value tensor on every call (PyG's ``GCNConv`` with
    ``cached=False``) is a new entry each time; the cache keeps
    ``CACHE_SIZE`` of them, and the graphs and plans it drops are freed."""
    g = sparse_graph(seed=4)
    n = g.nnz
    rowptr, col = g.rowptr.long(), g.col[:n].long()
    x = torch.randn(g.num_cols, K)
    sizes, builds = [], 0
    for i in range(torch_bridge.CACHE_SIZE + 3):
        value = torch.rand(n, generator=torch.Generator().manual_seed(i))
        src = FakeSparseTensor(rowptr, col, value, g.shape)
        want = pt.spmm(g.with_value(torch.cat(
            [value, value.new_zeros(g.nnz_padded - n)])), x,
            backend="reference")
        torch.testing.assert_close(torch_spmm(src, x), want, rtol=1e-5,
                                   atol=1e-5)
        builds += len(tileable)
        del src
        tileable.clear()  # the count holds the graphs it built
        gc.collect()
        sizes.append((len(torch_bridge._graph_cache), len(tiling._AUTO_TILED)))
    assert builds == torch_bridge.CACHE_SIZE + 3  # one build a call
    full = torch_bridge.CACHE_SIZE
    assert sizes[full - 1:] == [sizes[full - 1]] * 4
    assert sizes[-1][0] == full
