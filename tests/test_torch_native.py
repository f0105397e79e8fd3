"""The port's native graph and plan builder (``isplib_tpu_torch.native``)
against its numpy builds and the JAX package's native library.

Every array the native route builds must equal the port's numpy build
(``native.available`` patched to False, the reference) and the JAX
package's native build, bf16 bit for bit:

* ``sort_csr`` against ``np.lexsort`` and JAX's ``native.sort_csr``;
* ``_build_arrays``, field for field;
* the v1, v2 and v3 plans, v5's block counts and the v5 plan;
* a dense block with duplicate edges: the native fill sums them in
  float32 in edge order, as JAX's native fill does (bit for bit); the
  port's numpy v3 build sums them in float64, which lands one bf16 ulp
  away on a float32 rounding tie (shown here, written down in
  ``sparse/tiling_v3.py``);
* an empty graph and unsorted input never reach the native v2 and v3
  routes;
* ``native.rmat`` against JAX's ``native.rmat`` bit for bit at any thread
  count, and ``rmat_edges``'s default stream unchanged;
* a compiler that fails, or is missing, raises with its output; a forked
  child builds plans without hanging on the parent's OpenMP threads.
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch

import isplib_tpu.native as jax_native
from isplib_tpu.data.synthetic import rmat_edges as jax_rmat_edges
from isplib_tpu.sparse.graph import _build_arrays as jax_build_arrays
from isplib_tpu.sparse.tiling import _build_plan_arrays as jax_build_v1
from isplib_tpu.sparse.tiling_v2 import build_plan_v2_arrays as jax_build_v2
from isplib_tpu.sparse.tiling_v3 import build_plan_v3_arrays as jax_build_v3
from isplib_tpu_torch import native
from isplib_tpu_torch.data.synthetic import rmat_edges
from isplib_tpu_torch.kernels import build as kbuild
from isplib_tpu_torch.native import build as nbuild
from isplib_tpu_torch.sparse import graph as pgraph
from isplib_tpu_torch.sparse.tiling import build_plan_v1_arrays
from isplib_tpu_torch.sparse.tiling_v2 import build_plan_v2_arrays
from isplib_tpu_torch.sparse.tiling_v3 import build_plan_v3_arrays
from isplib_tpu_torch.sparse.tiling_v5 import build_hybrid_plan

GRAPH_FIELDS = ("rowptr", "row", "col", "value", "csc_colptr", "csc_row",
                "csc_col", "csc_value", "csc2csr", "deg", "deg_t")


def coo(seed=0, num_rows=700, num_cols=650, nnz=9000, sort=True):
    """Half the edges in a 300x260 corner (dense blocks), half uniform, 500
    of them twice; CSR-sorted as a graph passes them, unless ``sort`` is
    False."""
    rng = np.random.default_rng(seed)
    h = nnz // 2
    row = np.concatenate([rng.integers(0, 300, h),
                          rng.integers(0, num_rows, nnz - h)])
    col = np.concatenate([rng.integers(0, 260, h),
                          rng.integers(0, num_cols, nnz - h)])
    row = np.concatenate([row, row[:500]])
    col = np.concatenate([col, col[:500]])
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    if sort:
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
    return row, col, val, num_rows, num_cols


def numpy_build(fn, *args, **kw):
    """``fn`` with the port's native builder switched off (the numpy
    reference builds)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return fn(*args, **kw)


def as_np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def same(got, want, name):
    got, want = as_np(got), as_np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def same_plan(a, b, path="plan"):
    """Two port plans (dataclasses of tensors, schedules included) equal
    field for field, bf16 bit for bit."""
    if isinstance(a, torch.Tensor):
        same(a, b, path)
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            same_plan(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def no_native_call(monkeypatch):
    """Make every native plan entry point raise, so a route that reaches
    one fails."""
    def refuse(*args, **kw):
        raise AssertionError("the native route was taken")
    for name in ("plan_chunks", "plan_chunks_v2", "bsr_count", "bsr_fill",
                 "compact_residual"):
        monkeypatch.setattr(native, name, refuse)


# ---------------------------------------------------------------------------
# sorts and graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "duplicates", "one-row",
                                  "empty"])
def test_sort_csr_matches_lexsort_and_jax(case):
    rng = np.random.default_rng(1)
    nr, nc, nnz = 300, 400, 5000
    row = rng.integers(0, nr, nnz)
    col = rng.integers(0, nc, nnz)
    if case == "duplicates":
        row, col = np.tile(row[:50], 40), np.tile(col[:50], 40)
    elif case == "one-row":
        row = np.full(nnz, 7)
    elif case == "empty":
        row, col = row[:0], col[:0]
    order, rowptr = native.sort_csr(row, col, nr, nc)
    assert order.dtype == np.int32 and rowptr.dtype == np.int64
    same(order, np.lexsort((col, row)).astype(np.int32), "order")
    same(rowptr, np.concatenate([[0], np.cumsum(
        np.bincount(row, minlength=nr))]).astype(np.int64), "rowptr")
    jorder, jrowptr = jax_native.sort_csr(row, col, nr, nc)
    same(order, jorder, "order vs JAX")
    same(rowptr, jrowptr, "rowptr vs JAX")


@pytest.mark.parametrize("case", ["square", "rectangular", "weighted",
                                  "no-edges"])
def test_build_arrays_native_equals_numpy_and_jax(case):
    rng = np.random.default_rng(2)
    nr, nc, nnz = 150, 150, 2000
    if case == "rectangular":
        nc = 230
    row, col = rng.integers(0, nr, nnz), rng.integers(0, nc, nnz)
    val = (rng.normal(size=nnz).astype(np.float32) if case == "weighted"
           else None)
    if case == "no-edges":
        row, col = row[:0], col[:0]
    got = pgraph._build_arrays(row, col, val, nr, nc, 256)
    want = numpy_build(pgraph._build_arrays, row, col, val, nr, nc, 256)
    jax = jax_build_arrays(row, col, val, nr, nc, 256)
    assert jax_native.available()
    for f in GRAPH_FIELDS:
        same(got[f], want[f], f)
        same(got[f], jax[f], f"{f} vs JAX")
    for f in ("num_rows", "num_cols", "nnz"):
        assert got[f] == want[f] == jax[f], f


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [(256, 512, 512), (128, 128, 128),
                                      (64, 64, 256)])
def test_plan_v1_native_equals_numpy_and_jax(geometry):
    row, col, val, r, c = coo()
    p = build_plan_v1_arrays(row, col, val, r, c, *geometry, device="cpu")
    same_plan(p, numpy_build(build_plan_v1_arrays, row, col, val, r, c,
                             *geometry, device="cpu"))
    jp = jax_build_v1(row, col, val, r, c, *geometry)
    for f in ("edges", "rb_ids", "ct_ids", "chunk_starts"):
        same(getattr(p, f), getattr(jp, f), f)
    assert (p.nc, p.fill) == (jp.nc, jp.fill)


V2_CASES = {"square": (700, 650, dict(rb=128, ct=128, eb=128, k=16)),
            "supers": (700, 650, dict(rb=128, ct=128, eb=128, k=41,
                                      vmem_out_bytes=1 << 15)),
            "wide": (700, 1040, dict(rb=128, ct=256, eb=256, k=32)),
            "defaults": (700, 650, dict())}


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_plan_v2_native_equals_numpy_and_jax(case):
    r, c, kw = V2_CASES[case]
    row, col, val, _, _ = coo(3, r, c)
    p = build_plan_v2_arrays(row, col, val, r, c, device="cpu", **kw)
    same_plan(p, numpy_build(build_plan_v2_arrays, row, col, val, r, c,
                             device="cpu", **kw))
    jp = jax_build_v2(row, col, val, r, c, **kw)
    for f in ("edges", "rb_locals", "cell_starts"):
        same(getattr(p, f), getattr(jp, f), f)
    assert (p.nc, p.n_super, p.fill) == (jp.nc, jp.n_super, jp.fill)
    assert (p.n_super > 1) == (case == "supers")


V3_CASES = {
    "tuner-g4": dict(rb=256, ct=128, eb=512, dense_threshold=8, g=4, k=32),
    "supers": dict(rb=128, ct=128, eb=128, dense_threshold=20, g=2, k=41,
                   vmem_out_bytes=1 << 15),
    "all-dense": dict(rb=128, ct=128, eb=128, dense_threshold=1, g=8, k=8),
    "no-dense": dict(dense_threshold=10_000),
}


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_plan_v3_native_equals_numpy_and_jax(case):
    row, col, val, r, c = coo()
    kw = V3_CASES[case]
    p = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    same_plan(p, numpy_build(build_plan_v3_arrays, row, col, val, r, c,
                             device="cpu", **kw))
    jp = jax_build_v3(row, col, val, r, c, **kw)
    assert (p.bsr is None) == (jp.bsr is None) == (case == "no-dense")
    if p.bsr is not None:
        for f in ("blocks", "rb_locals", "cell_starts"):
            same(getattr(p.bsr, f), getattr(jp.bsr, f), f)
    assert (p.residual is None) == (jp.residual is None)
    if p.residual is not None:
        for f in ("edges", "rb_locals", "cell_starts"):
            same(getattr(p.residual, f), getattr(jp.residual, f),
                 f"residual.{f}")
    assert (p.dense_edges, p.sparse_edges) == (jp.dense_edges,
                                               jp.sparse_edges)


@pytest.mark.parametrize("threshold", [1, 20, 64, 10_000])
def test_plan_v5_native_equals_numpy_and_jax_counts(threshold):
    row, col, val, r, c = coo()
    n_br, n_bc = -(-r // 128), -(-c // 128)
    counts = native.bsr_count(row, col, 128, n_br, n_bc)
    same(counts, jax_native.bsr_count(row, col, 128, n_br, n_bc),
         "counts vs JAX")
    same(counts, np.bincount((row // 128) * n_bc + col // 128,
                             minlength=n_br * n_bc).astype(np.int32),
         "counts vs bincount")
    p = build_hybrid_plan(row, col, val, r, c, "cpu",
                          dense_threshold=threshold)
    same_plan(p, numpy_build(build_hybrid_plan, row, col, val, r, c, "cpu",
                             dense_threshold=threshold))
    assert p.dense_edges == int(counts[counts >= threshold].sum())


def dup_block_graph():
    """One 128x128 block of 200 edges, three of them on entry (5, 9):
    1 + 2⁻⁸ and twice 3·2⁻²⁶.  Float32 summing in edge order keeps 1 + 2⁻⁸
    (each small value is below half a float32 ulp), a bf16 tie that rounds
    to 1.0; the float64 sum passes the tie and rounds up to 1 + 2⁻⁷."""
    rng = np.random.default_rng(4)
    cells = rng.choice(128 * 128, 197, replace=False)
    cells = cells[cells != 5 * 128 + 9][:196]
    row = np.concatenate([cells // 128, [5, 5, 5]])
    col = np.concatenate([cells % 128, [9, 9, 9]])
    val = np.concatenate([np.full(196, 0.5, np.float32),
                          np.float32([1 + 2**-8, 3 * 2**-26, 3 * 2**-26])])
    order = np.lexsort((col, row))
    return row[order], col[order], val[order], 256, 256


def test_duplicates_in_a_dense_block():
    row, col, val, r, c = dup_block_graph()
    kw = dict(dense_threshold=64, g=2)
    p = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    jp = jax_build_v3(row, col, val, r, c, **kw)
    same(p.bsr.blocks, jp.bsr.blocks, "v3 blocks vs JAX's native build")
    got = as_np(p.bsr.blocks)
    ref = as_np(numpy_build(build_plan_v3_arrays, row, col, val, r, c,
                            device="cpu", **kw).bsr.blocks)
    # blocks[group, c, j·128 + r]: the entry (5, 9) of member 0
    assert got[0, 9, 5] == np.int16(0x3F80)        # 1.0
    assert ref[0, 9, 5] == np.int16(0x3F81)        # 1 + 2⁻⁷, one ulp up
    diff = np.argwhere(got != ref)
    assert diff.tolist() == [[0, 9, 5]]
    # v5 sums in float32 on both routes: equal bit for bit
    p5 = build_hybrid_plan(row, col, val, r, c, "cpu", dense_threshold=64)
    same_plan(p5, numpy_build(build_hybrid_plan, row, col, val, r, c, "cpu",
                              dense_threshold=64))
    assert as_np(p5.blocks)[0, 5, 9] == np.int16(0x3F80)


@pytest.mark.parametrize("case", ["v2-unsorted", "v3-unsorted",
                                  "v1-unsorted", "v2-empty", "v3-empty",
                                  "v1-empty", "v5-empty"])
def test_empty_and_unsorted_input_take_the_numpy_build(case, no_native_call):
    version, kind = case.split("-")
    row, col, val, r, c = coo(5, sort=(kind != "unsorted"))
    assert kind == "empty" or bool(np.any(row[1:] < row[:-1]))
    if kind == "empty":
        row, col, val = row[:0], col[:0], val[:0]
    build = {"v1": lambda: build_plan_v1_arrays(row, col, val, r, c, 128,
                                                128, 128, device="cpu"),
             "v2": lambda: build_plan_v2_arrays(row, col, val, r, c, rb=128,
                                                ct=128, eb=128,
                                                device="cpu"),
             "v3": lambda: build_plan_v3_arrays(row, col, val, r, c,
                                                dense_threshold=20,
                                                device="cpu"),
             "v5": lambda: build_hybrid_plan(row, col, val, r, c, "cpu")
             }[version]
    same_plan(build(), numpy_build(build))


def test_native_routes_check_their_input():
    row, col, val, r, c = coo()
    with pytest.raises(ValueError, match="outside"):
        native.sort_csr(row, col, r, 100)
    with pytest.raises(ValueError, match="outside"):
        native.bsr_count(row - 1, col, 128, 6, 6)
    with pytest.raises(ValueError, match="row-sorted"):
        native.plan_chunks_v2(row[::-1], col, val, r, c, 128, 128, 128, 1)
    with pytest.raises(ValueError, match="int32"):
        native.rmat(10, 2**31 + 1)
    with pytest.raises(ValueError, match="edges"):
        native.plan_chunks(row, col, val[:-1], r, c, 128, 128, 128)


# ---------------------------------------------------------------------------
# R-MAT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", [1, 3, 8])
def test_rmat_matches_jax_at_any_thread_count(threads):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        src, dst = native.rmat(200_000, 11_648, seed=12345)
    finally:
        torch.set_num_threads(before)
    jsrc, jdst = jax_native.rmat(200_000, 11_648, seed=12345)
    same(src, jsrc, "src")
    same(dst, jdst, "dst")
    assert src.min() >= 0 and src.max() < 11_648


def test_rmat_edges_streams(monkeypatch):
    """The default stream is JAX's numpy stream (a seed names the same
    graph as before); ``native_stream`` is JAX's native stream."""
    got = rmat_edges(3000, 50_000, seed=9)
    native_got = rmat_edges(3000, 50_000, seed=9, native_stream=True)
    assert jax_native.available()
    same(native_got, jax_rmat_edges(3000, 50_000, seed=9), "native stream")
    monkeypatch.setattr(jax_native, "available", lambda: False)
    same(got, jax_rmat_edges(3000, 50_000, seed=9), "numpy stream")
    assert not np.array_equal(got[:, :100], native_got[:, :100])


# ---------------------------------------------------------------------------
# build and process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_a_failing_compiler_raises(compiler, tmp_path, monkeypatch):
    script = tmp_path / "cxx"
    if compiler == "fails":
        script.write_text("#!/bin/sh\necho 'graphbuild.cpp:1: error: no "
                          "compiler here' >&2\nexit 1\n")
        script.chmod(0o755)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nbuild, "CXX", str(script))
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError) as err:
            pgraph._build_arrays(np.array([0, 1]), np.array([1, 0]), None,
                                 2, 2, 128)
    finally:
        native._load.cache_clear()
    msg = str(err.value)
    if compiler == "fails":
        assert "no compiler here" in msg and "-fopenmp" in msg
        assert not nbuild.lib_path().exists()
    else:
        assert "not found" in msg


def _child_builds(q, row, col, val, want):
    edges = native.plan_chunks(row, col, val, 3000, 3000, 128, 128, 128)[0]
    q.put(bool(np.array_equal(edges, want)))


@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_a_forked_child_builds_plans():
    """GNU libgomp's pool does not survive fork(); the child runs the
    builder on one thread instead of waiting for the parent's."""
    rng = np.random.default_rng(6)
    row = np.sort(rng.integers(0, 3000, 200_000))
    col = rng.integers(0, 3000, 200_000)
    val = np.ones(200_000, np.float32)
    want = native.plan_chunks(row, col, val, 3000, 3000, 128, 128, 128)[0]
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_child_builds, args=(q, row, col, val, want))
    p.start()
    try:
        assert q.get(timeout=60) is True
    finally:
        p.join(30)
        if p.is_alive():
            p.kill()
    assert p.exitcode == 0
