"""The port's plain versions and ``chip_smoke.py``'s full-size helpers, on
the CPU at a small size.

At 114.8M edges the plain versions of K1 and K2 run over chunks of
features whose temporaries stay within ``reference.CHUNK_BYTES`` (phase 14
of ``chip_smoke.py``).  Here ``CHUNK_BYTES`` is patched small enough to
force at least three chunks, and each chunked call is held to the same
call in one piece: bit for bit for K1 and its float64 oracle (each output
column sums the same edges in the same order), 1e-6 relative for K2
(``bmm`` may sum another way at another width).  The hybrid SpMM under
forced chunks is held to the JAX package's XLA SpMM; the row-range
reference and the K3 column sample of phase 14 to ``xla_backend`` and
``reference.spmm_arg_raw`` on a graph with a hub row larger than one
range.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isplib_tpu
import isplib_tpu_torch as pt
from isplib_tpu.ops import xla_backend
from isplib_tpu_torch.kernels import spmm_bsr, spmm_minmax_v4, spmm_stream
from isplib_tpu_torch.kernels.spmm_hybrid import spmm_hybrid
from isplib_tpu_torch.ops import reference
from isplib_tpu_torch.sparse.tiling import build_tiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

KS = (41, 200)            # an odd width and one above a K tile of 128
DIRECTIONS = ("fwd", "bwd")
HUB_ROW, HUB_EDGES = 300, 700


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, which the native graph and plan build also
    takes, while this module runs: the suite runs several test files at
    once, one a worker, and a wall-clock test may run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hub():
    """(port graph, JAX graph, its v5 tiling at 64): a dense 256×256
    corner (densified), uniform edges (residual) and a hub row of
    ``HUB_EDGES`` edges, larger than one K3 item and than a row range of
    the reference when ``REF_EDGES`` is patched to 256."""
    rng = np.random.default_rng(16)
    num_rows, num_cols, nnz = 1200, 1100, 8000
    nh = nnz // 2
    row = np.concatenate([rng.integers(0, 256, nh),
                          rng.integers(0, num_rows, nnz - nh),
                          np.full(HUB_EDGES, HUB_ROW)])
    col = np.concatenate([rng.integers(0, 256, nh),
                          rng.integers(0, num_cols, nnz - nh),
                          rng.integers(0, num_cols, HUB_EDGES)])
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    ei = np.stack([col, row])
    kw = dict(num_nodes=num_rows, num_src_nodes=num_cols, edge_value=val,
              edge_multiple=128)
    tg = pt.from_edge_index(ei, device="cpu", **kw)
    return tg, isplib_tpu.from_edge_index(ei, **kw), build_tiling(
        tg, dense_threshold=64)


def plan_of(tiled, direction):
    return tiled.fwd if direction == "fwd" else tiled.bwd


def operand(rows, k, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, k)).astype(np.float32))


def force_chunks(monkeypatch, edges, k, itemsize=4):
    """Patch ``CHUNK_BYTES`` so that ``edges`` (per-edge temporaries of
    ``_SUM_EDGE_FEATURE_BYTES``) take at least three chunks at width k."""
    monkeypatch.setattr(reference, "CHUNK_BYTES",
                        reference._SUM_EDGE_FEATURE_BYTES * edges
                        * max(1, k // 4))
    n = len(reference._chunks(edges, k, reference._SUM_EDGE_FEATURE_BYTES,
                              itemsize))
    assert n >= 3
    return n


def test_chunks_scale_by_element_size(monkeypatch):
    """A float64 operand's chunks hold half the features of an fp32 one's,
    so its temporaries stay within ``CHUNK_BYTES`` too."""
    monkeypatch.setattr(reference, "CHUNK_BYTES", 8 * 1000 * 10)
    f32 = reference._chunks(1000, 40, 8)
    f64 = reference._chunks(1000, 40, 8, itemsize=8)
    assert [c.stop - c.start for c in f32] == [10] * 4
    assert [c.stop - c.start for c in f64] == [5] * 8


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_k1_plain_chunked_bit_for_bit(hub, monkeypatch, direction, k):
    plan = plan_of(hub[2], direction)
    assert plan.sparse_edges > 0
    x = operand(plan.num_cols, k, k)
    out0 = operand(plan.num_rows, k, k + 1)
    whole = out0.clone()
    spmm_stream.spmm_stream_plain(plan, x, whole)
    force_chunks(monkeypatch, plan.sparse_edges, k)
    got = out0.clone()
    spmm_stream.spmm_stream_plain(plan, x, got)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_k1_oracle_chunked_bit_for_bit(hub, monkeypatch, direction, k):
    plan = plan_of(hub[2], direction)
    x = operand(plan.num_cols, k, k)
    out = operand(plan.num_rows, k, k + 1)
    whole = spmm_stream.spmm_stream_oracle(plan, x, out)
    assert force_chunks(monkeypatch, plan.sparse_edges, k, itemsize=8) >= 6
    got = spmm_stream.spmm_stream_oracle(plan, x, out)
    assert got.dtype == torch.float64 and torch.equal(got, whole)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_k2_plain_chunked(hub, monkeypatch, direction, k):
    plan = plan_of(hub[2], direction)
    assert plan.nb > 0
    x = operand(plan.num_cols, k, k)
    whole = spmm_bsr.spmm_bsr_plain(plan, x)
    force_chunks(monkeypatch, plan.nb * 128, k)
    got = spmm_bsr.spmm_bsr_plain(plan, x)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("version", (5, 4))
def test_hybrid_chunked_matches_xla(hub, monkeypatch, version, direction,
                                    k):
    """The CPU hybrid SpMM (the plain versions) under forced chunks against
    ``xla_backend`` on the same seeded inputs: the bf16 contract (2e-2) on
    the v5 plan with dense blocks, 1e-5 on the residual-only v4 plan."""
    tg, jg, tiled = hub
    if version == 4:
        tiled = build_tiling(tg, version=4)
    plan = plan_of(tiled, direction)
    assert (plan.nb > 0) == (version == 5)
    j = jg if direction == "fwd" else jg.transpose()
    x = np.random.default_rng(k).normal(size=(j.num_cols, k)).astype(
        np.float32)
    force_chunks(monkeypatch, max(plan.sparse_edges, plan.nb * 128), k)
    got = spmm_hybrid(plan, torch.from_numpy(x)).numpy()
    want = np.asarray(xla_backend.spmm_raw(j.row, j.col, j.value, j.deg,
                                           jnp.asarray(x), j.num_rows,
                                           "sum"))
    tol = 2e-2 if version == 5 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("k", KS)
def test_reference_by_rows_matches_xla(hub, monkeypatch, k):
    """``chip_smoke.reference_by_rows`` with ranges of 256 edges (the hub
    row of 700+ whole in one range) and forced feature chunks, against
    ``xla_backend``'s SpMM of the whole graph at 1e-5."""
    tg, jg, _ = hub
    monkeypatch.setattr(chip_smoke, "REF_EDGES", 256)
    force_chunks(monkeypatch, 256, k)
    rowptr = tg.rowptr.numpy()
    assert rowptr[HUB_ROW + 1] - rowptr[HUB_ROW] > 256
    x = np.random.default_rng(k).normal(size=(tg.num_cols, k)).astype(
        np.float32)
    got = chip_smoke.reference_by_rows(tg, torch.from_numpy(x)).numpy()
    want = np.asarray(xla_backend.spmm_raw(jg.row, jg.col, jg.value, jg.deg,
                                           jnp.asarray(x), jg.num_rows,
                                           "sum"))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_mm_sample_columns():
    """Phase 14's K3 sample at K = 602: at least 96 columns, the ragged
    tail and both sides of every K-tile boundary of the walk; every column
    up to 128."""
    assert chip_smoke.mm_sample(32) is None
    assert chip_smoke.mm_sample(chip_smoke.MM_FULL_COLS) is None
    cols = chip_smoke.mm_sample(602)
    assert len(cols) >= chip_smoke.MM_SAMPLE_MIN
    assert cols == sorted(set(cols)) and cols[-1] == 601
    assert set(range(578, 602)) <= set(cols)
    for b in (128, 256, 384, 512):
        assert {b - 1, b} <= set(cols)


@pytest.mark.parametrize("reduce", ("max", "min"))
def test_minmax_sample_matches_reference(hub, monkeypatch, reduce):
    """The K3 check of phase 14 at a wide K: the plain version and the
    reference path called on the sampled columns of x give, bit for bit,
    the sampled columns of ``reference.spmm_arg_raw`` over every column,
    with global edge ids, on a graph whose hub row is split over several
    walk items; under forced chunks."""
    tg, _, tiled = hub
    plan, sentinel = tiled.fwd_mm, tg.nnz_padded - 1
    assert plan.sched.nsplit > 0
    k = 300
    cols = chip_smoke.mm_sample(k)
    x = operand(tg.num_cols, k, 7)
    want, want_arg = reference.spmm_arg_raw(tg.row, tg.col, tg.value, tg.deg,
                                            x, tg.num_rows, reduce)
    assert int(want_arg[HUB_ROW].min()) > 1000  # global ids, past row 0's
    monkeypatch.setattr(reference, "CHUNK_BYTES", 32 * tg.nnz_padded * 4)
    xs = x[:, cols].contiguous()
    sel = torch.tensor(cols)
    for out, arg in (
            spmm_minmax_v4.spmm_minmax_v4_plain(plan, tg.col, tg.value, xs,
                                                reduce, sentinel),
            reference.spmm_arg_raw(tg.row, tg.col, tg.value, tg.deg, xs,
                                   tg.num_rows, reduce)):
        assert torch.equal(out.view(torch.int32),
                           want.index_select(1, sel).view(torch.int32))
        assert torch.equal(arg, want_arg.index_select(1, sel))
