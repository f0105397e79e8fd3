"""The port's max/min SpMM (K3's plain version, its plan and its dispatch)
against the JAX package: values within 1e-6 (exact fp32 on both sides; the
tolerance is the one ``tests/test_minmax_train.py`` holds the Pallas kernel
to), winning edge ids exactly, gradients within 1e-5."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isplib_tpu
import isplib_tpu_torch as pt
from isplib_tpu.kernels.spmm_minmax_v4 import spmm_minmax_v4 as jax_k3
from isplib_tpu.ops import xla_backend
from isplib_tpu.sparse.tiling import build_tiling as jax_build_tiling
from isplib_tpu.sparse.tiling_v4mm import build_minmax_stripes
from isplib_tpu_torch.kernels import spmm_minmax_v4 as k3
from isplib_tpu_torch.ops import reference
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.sparse.tiling_v4mm import MinMaxPlan
from isplib_tpu_torch.sparse.tiling_v5 import SEG_EDGES

N, E = 300, 6000  # the sizes of tests/test_minmax_train.py


def coo(seed, ties):
    """Rows 260..299 empty; half the edges in 3 hub rows of ~1000 edges
    (4 segments each).  ``ties``: unit values and every tenth edge 0, so
    products tie and ±0.0 meet; else normal values."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - 40, E)
    src = rng.integers(0, N, E)
    hub = rng.random(E) < 0.5
    dst[hub] = rng.integers(0, 3, hub.sum())
    if ties:
        val = np.ones(E, np.float32)
        val[::10] = 0.0
    else:
        val = rng.normal(size=E).astype(np.float32)
    return np.stack([src, dst]), val


def graphs(seed, ties):
    ei, val = coo(seed, ties)
    kw = dict(num_nodes=N, edge_value=val, edge_multiple=128)
    return (pt.from_edge_index(ei, device="cpu", **kw),
            isplib_tpu.from_edge_index(ei, **kw))


def features(seed, k, ties):
    x = np.random.default_rng(seed + 100).normal(size=(N, k))
    return (np.round(x) if ties else x).astype(np.float32)


@pytest.mark.parametrize("k", [32, 41])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("red", ["max", "min"])
def test_plain_k3_matches_jax(red, ties, k):
    tg, jg = graphs(3, ties)
    x = features(3, k, ties)
    plan = build_tiling(tg).fwd_mm
    out, arg = k3.spmm_minmax_v4(plan, tg.col, tg.value, torch.from_numpy(x),
                                 red, tg.nnz_padded - 1)
    assert out.dtype == torch.float32 and arg.dtype == torch.int32
    n = jg.nnz
    jplans = build_minmax_stripes(
        np.asarray(jg.row)[:n], np.asarray(jg.col)[:n],
        np.asarray(jg.value)[:n], N, N, k=k)
    want, want_arg = jax_k3(jplans, jnp.asarray(x), red, jg.nnz_padded - 1)
    ref, ref_arg = xla_backend.spmm_arg_raw(
        jg.row, jg.col, jg.value, jg.deg, jnp.asarray(x), N,
        isplib_tpu.Reduce.of(red))
    for w, wa in ((want, want_arg), (ref, ref_arg)):
        np.testing.assert_allclose(out.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(arg.numpy(), np.asarray(wa))
    empty = tg.deg.numpy() == 0
    assert empty.any()
    assert bool((out[empty] == 0).all())
    assert bool((arg[empty] == tg.nnz_padded - 1).all())


def test_plain_k3_out_is_the_winners_product():
    """Where ±0.0 tie, out keeps the sign of the lowest-id winner's own
    product (the kernel's bit-exact contract)."""
    tg, _ = graphs(3, True)
    x = torch.from_numpy(features(3, 32, True))
    plan = build_tiling(tg).fwd_mm
    for red in ("max", "min"):
        out, arg = k3.spmm_minmax_v4(plan, tg.col, tg.value, x, red,
                                     tg.nnz_padded - 1)
        hit = arg < tg.nnz
        a = arg.long().clamp(max=tg.nnz - 1)
        feat = torch.arange(32).expand_as(a)
        prod = tg.value[a] * x[tg.col.long()[a], feat]
        assert torch.equal(out[hit].view(torch.int32),
                           prod[hit].view(torch.int32))
        assert bool((out[~hit].view(torch.int32) == 0).all())


def test_plan_covers_every_edge_once():
    tg, _ = graphs(3, False)
    plan = build_tiling(tg).fwd_mm
    ptr, row = plan.seg_ptr.numpy(), plan.seg_row.numpy()
    rowptr = tg.rowptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == tg.nnz == plan.nnz
    lens = np.diff(ptr)
    assert lens.min() >= 0 and lens.max() <= SEG_EDGES
    # segments are contiguous and ascending, each inside its row
    assert np.all(ptr[:-1] >= rowptr[row]) and np.all(ptr[1:] <= rowptr[row + 1])
    # every row has at least one segment (empty rows one empty segment)
    assert np.array_equal(np.unique(row), np.arange(N))
    assert np.all(lens[np.diff(rowptr)[row] == 0] == 0)
    per_row = np.bincount(row, minlength=N)
    split = np.flatnonzero(per_row > 1)
    np.testing.assert_array_equal(plan.split_rows.numpy(), split)
    assert set(split) >= {0, 1, 2}  # the hubs
    slot = plan.seg_slot.numpy()
    assert np.all(slot[per_row[row] == 1] == -1)
    np.testing.assert_array_equal(plan.split_rows.numpy()[
        slot[per_row[row] > 1]], row[per_row[row] > 1])


def test_auto_tile_builds_the_minmax_plan(monkeypatch):
    """Every tiling carries ``fwd_mm``, as the JAX package's auto_tile does,
    and auto_tile tiles through build_tiling (only CUDA graphs are tiled, so
    the graph is faked to be there)."""
    tg, _ = graphs(3, False)
    tiled = build_tiling(tg)
    assert isinstance(tiled.fwd_mm, MinMaxPlan)
    assert tiled.fwd_mm.nnz == tg.nnz
    seen = []
    monkeypatch.setattr(pt.sparse.tiling, "AUTO_TILE_MIN_NNZ", 1)
    monkeypatch.setattr(pt.sparse.tiling, "build_tiling",
                        lambda g, **kw: seen.append(g) or tiled)
    monkeypatch.setattr(type(tg), "device", property(
        lambda self: torch.device("cuda", 0)))
    assert pt.sparse.tiling.auto_tile(tg).fwd_mm is tiled.fwd_mm
    assert seen == [tg]


@pytest.mark.parametrize("red", ["max", "min"])
def test_spmm_dispatches_through_fwd_mm(monkeypatch, red):
    tg, _ = graphs(3, False)
    tiled = build_tiling(tg)
    x = torch.from_numpy(features(3, 8, False))
    calls = []
    plain = k3.spmm_minmax_v4_plain
    monkeypatch.setattr(k3, "spmm_minmax_v4_plain",
                        lambda *a: calls.append(a[0]) or plain(*a))
    got = pt.spmm(tiled, x, red)
    assert calls == [tiled.fwd_mm]
    want = pt.spmm(tg, x, red)
    assert torch.equal(got, want)
    # with backend="reference" the reference runs
    pt.spmm(tiled, x, red, backend="reference")
    assert len(calls) == 1


@pytest.mark.parametrize("red", ["max", "min"])
def test_grads_match_jax_grad_on_minmax_plan(red):
    """grad x and grad value through K3 (plain version) against jax.grad of
    the JAX spmm on a graph tiled with build_minmax=True (Pallas K3 in
    interpret mode)."""
    tg, jg = graphs(4, True)
    tiled = build_tiling(tg)
    jtiled = jax_build_tiling(jg, rb=128, ct=128, eb=128, k=16,
                              build_minmax=True)
    rng = np.random.default_rng(6)
    x = features(4, 16, True)
    w = rng.normal(size=(N, 16)).astype(np.float32)

    def jloss(value, xx):
        graph = dataclasses.replace(
            jtiled, graph=dataclasses.replace(jtiled.graph, value=value))
        return jnp.sum(isplib_tpu.spmm(graph, xx, red, backend="pallas")
                       * w)

    jv, jx = jax.grad(jloss, argnums=(0, 1))(jg.value, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    v = tg.value.clone().requires_grad_(True)
    out = pt.SpMM.apply(tiled, pt.Reduce.of(red), "auto", xt, v)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert bool((v.grad[tg.nnz:] == 0).all())


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min"])
def test_chunked_reference_is_bitwise_unchunked(monkeypatch, red):
    """The reference path over chunks of features equals one pass over all
    of them, bit for bit (features are independent)."""
    arg = red in ("max", "min")
    tg, _ = graphs(5, arg)
    x = torch.from_numpy(features(5, 41, True))
    args = (tg.row, tg.col, tg.value, tg.deg, x, N, red)
    per = (reference._ARG_EDGE_FEATURE_BYTES if arg
           else reference._SUM_EDGE_FEATURE_BYTES)

    def run():
        return (reference.spmm_arg_raw(*args) if arg
                else (reference.spmm_raw(*args),))

    # a small graph at K = 41 fits the default budget: one pass
    assert reference._chunks(tg.nnz_padded, 41, per) == [slice(0, 41)]
    whole = run()
    monkeypatch.setattr(reference, "CHUNK_BYTES", tg.nnz_padded * per * 3)
    assert [s.stop - s.start for s in reference._chunks(tg.nnz_padded, 41,
                                                        per)
            ] == [3] * 13 + [2]
    parts = run()
    for a, b in zip(whole, parts):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k3_plain_is_chunked(monkeypatch):
    tg, _ = graphs(5, True)
    plan = build_tiling(tg).fwd_mm
    x = torch.from_numpy(features(5, 41, True))
    whole = k3.spmm_minmax_v4(plan, tg.col, tg.value, x, "max",
                              tg.nnz_padded - 1)
    monkeypatch.setattr(reference, "CHUNK_BYTES", tg.nnz * 32 * 5)
    parts = k3.spmm_minmax_v4(plan, tg.col, tg.value, x, "max",
                              tg.nnz_padded - 1)
    for a, b in zip(whole, parts):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
