"""The port's SpMM against the JAX package: reference ops, the hybrid plan,
the hybrid SpMM (plain versions on the CPU; the kernels on a card) and the
autograd op."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isplib_tpu
import isplib_tpu_torch as pt
from isplib_tpu.kernels.spmm_bsr2 import spmm_hybrid_v5
from isplib_tpu.ops import xla_backend
from isplib_tpu.sparse.tiling_v5 import build_plan_v5_arrays
from isplib_tpu_torch.kernels.spmm_hybrid import spmm_hybrid
from isplib_tpu_torch.kernels.spmm_stream import spmm_stream_oracle
from isplib_tpu_torch.ops import reference
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.sparse.tiling_v5 import BS, SEG_EDGES

REDUCES = ("sum", "mean", "max", "min")


def assert_close_bf16(got, want):
    """The dense half rounds x and the edge values to bf16 (8 mantissa bits,
    relative error ≤ 2^-9 each), and sums of a few hundred such products
    land within 2% of the largest output: the bf16 contract of
    tests/test_v5.py."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


def hub_coo(rng, num_rows, num_cols, nnz, hub_frac=0.5):
    """Half the edges in a dense 256x256 corner (densified), half spread
    uniformly (residual)."""
    nh = int(nnz * hub_frac)
    row = np.concatenate([rng.integers(0, min(256, num_rows), nh),
                          rng.integers(0, num_rows, nnz - nh)])
    col = np.concatenate([rng.integers(0, min(256, num_cols), nh),
                          rng.integers(0, num_cols, nnz - nh)])
    val = rng.normal(size=nnz).astype(np.float32)
    return row.astype(np.int64), col.astype(np.int64), val


def graphs(row, col, val, num_rows, num_cols):
    ei = np.stack([col, row])
    kw = dict(num_nodes=num_rows, num_src_nodes=num_cols, edge_value=val,
              edge_multiple=128)
    return (pt.from_edge_index(ei, device="cpu", **kw),
            isplib_tpu.from_edge_index(ei, **kw))


@pytest.fixture(scope="module")
def hub():
    rng = np.random.default_rng(0)
    num_rows, num_cols = 1200, 1100
    row, col, val = hub_coo(rng, num_rows, num_cols, 6000)
    # a hub row of three segments (its blocks stay below the threshold of
    # 128), and a row with no edges at all
    extra = 2 * SEG_EDGES + 10
    row = np.concatenate([row, np.full(extra, 300)])
    col = np.concatenate([col, rng.integers(0, num_cols, extra)])
    val = np.concatenate([val, rng.normal(size=extra).astype(np.float32)])
    keep = row != 301
    return graphs(row[keep], col[keep], val[keep], num_rows, num_cols)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ---------------------------------------------------------------------------
# reference ops vs isplib_tpu.ops.xla_backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", REDUCES)
def test_reference_spmm_matches_xla(hub, reduce):
    tg, jg = hub
    x = np.random.default_rng(1).normal(size=(tg.num_cols, 16)).astype(
        np.float32)
    got = reference.spmm_raw(tg.row, tg.col, tg.value, tg.deg, _t(x),
                             tg.num_rows, reduce)
    want = xla_backend.spmm_raw(jg.row, jg.col, jg.value, jg.deg,
                                jnp.asarray(x), jg.num_rows, reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("reduce", ("max", "min"))
def test_reference_arg_matches_xla_with_ties(reduce):
    # small integer features and unit values force many exact ties
    rng = np.random.default_rng(2)
    row = rng.integers(0, 40, 400)
    row[row == 7] = 8  # row 7 stays empty
    col = rng.integers(0, 30, 400)
    tg, jg = graphs(row, col, np.ones(400, np.float32), 40, 30)
    x = rng.integers(-2, 3, size=(30, 8)).astype(np.float32)
    out, arg = reference.spmm_arg_raw(tg.row, tg.col, tg.value, tg.deg,
                                      _t(x), 40, reduce)
    wout, warg = xla_backend.spmm_arg_raw(jg.row, jg.col, jg.value, jg.deg,
                                          jnp.asarray(x), 40, reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), rtol=1e-5)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(warg))
    assert bool((arg[7] == tg.nnz_padded - 1).all())


def test_reference_sddmm_matches_xla(hub):
    tg, jg = hub
    rng = np.random.default_rng(3)
    a = rng.normal(size=(tg.num_rows, 8)).astype(np.float32)
    b = rng.normal(size=(tg.num_cols, 8)).astype(np.float32)
    got = reference.sddmm_dot_raw(tg.row, tg.col, _t(a), _t(b))
    want = xla_backend.sddmm_dot_raw(jg.row, jg.col, jnp.asarray(a),
                                     jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the hybrid plan
# ---------------------------------------------------------------------------

def _host_coo(g):
    n = g.nnz
    return (g.row[:n].numpy().astype(np.int64),
            g.col[:n].numpy().astype(np.int64), g.value[:n].numpy())


def _check_partition(plan, row, col, val, num_rows, num_cols):
    """Every edge lands in exactly one half: the residual CSR holds exactly
    the edges of non-dense blocks, and the blocks hold the rest."""
    dense_blocks = set()
    brp = plan.blk_rowptr.numpy()
    for br in range(plan.n_br):
        for j in range(brp[br], brp[br + 1]):
            dense_blocks.add((br, int(plan.blk_col[j])))
    in_dense = np.array([(r // BS, c // BS) in dense_blocks
                         for r, c in zip(row, col)], bool)
    assert plan.dense_edges == int(in_dense.sum())
    assert plan.dense_edges + plan.sparse_edges == row.shape[0]
    rp = plan.res_rowptr.numpy()
    r_rows = np.repeat(np.arange(num_rows), np.diff(rp))
    np.testing.assert_array_equal(r_rows, row[~in_dense])
    np.testing.assert_array_equal(plan.res_col.numpy(), col[~in_dense])
    np.testing.assert_array_equal(plan.res_val.numpy(), val[~in_dense])
    a = np.zeros((plan.n_br * BS, -(-num_cols // BS) * BS), np.float32)
    np.add.at(a, (row[in_dense], col[in_dense]), val[in_dense])
    blocks = plan.blocks.float().numpy()
    for br in range(plan.n_br):
        for j in range(brp[br], brp[br + 1]):
            bc = int(plan.blk_col[j])
            want = torch.from_numpy(a[br * BS:(br + 1) * BS,
                                      bc * BS:(bc + 1) * BS]).to(
                torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(blocks[j], want)
    # segments tile the residual edges in order, each within one row and
    # at most SEG_EDGES long
    sp, sr = plan.seg_ptr.numpy(), plan.seg_row.numpy()
    assert sp[0] == 0 and sp[-1] == plan.sparse_edges
    assert np.all(np.diff(sp) > 0) and np.all(np.diff(sp) <= SEG_EDGES)
    assert np.all(sp[:-1] >= rp[sr]) and np.all(sp[1:] <= rp[sr + 1])


@pytest.mark.parametrize("thr", [16, 64, 600])
def test_plan_split_matches_jax(hub, thr):
    tg, _ = hub
    tiled = build_tiling(tg, dense_threshold=thr)
    row, col, val = _host_coo(tg)
    jplan = build_plan_v5_arrays(row, col, val, tg.num_rows, tg.num_cols,
                                 rb=128, dense_threshold=thr, S=2, g=4)
    assert tiled.fwd.dense_edges == jplan.dense_edges
    _check_partition(tiled.fwd, row, col, val, tg.num_rows, tg.num_cols)
    t = tg.transpose()
    trow, tcol, tval = _host_coo(t)
    jplan_t = build_plan_v5_arrays(trow, tcol, tval, t.num_rows, t.num_cols,
                                   rb=128, dense_threshold=thr, S=2, g=4)
    assert tiled.bwd.dense_edges == jplan_t.dense_edges
    _check_partition(tiled.bwd, trow, tcol, tval, t.num_rows, t.num_cols)


def test_plan_block_cap_raises_threshold(hub, monkeypatch):
    from isplib_tpu_torch.sparse import tiling_v5
    tg, _ = hub
    row, col, val = _host_coo(tg)
    cap = 3 * BS * BS * 2  # room for three bf16 blocks
    monkeypatch.setattr(tiling_v5, "MAX_BLOCK_BYTES", cap)
    plan = tiling_v5.build_hybrid_plan(row, col, val, tg.num_rows,
                                       tg.num_cols, torch.device("cpu"),
                                       dense_threshold=16)
    jplan = build_plan_v5_arrays(row, col, val, tg.num_rows, tg.num_cols,
                                 rb=128, dense_threshold=16, S=2, g=4,
                                 max_block_bytes=cap)
    assert plan.nb <= 3 and plan.dense_threshold > 16
    assert plan.dense_edges == jplan.dense_edges


# ---------------------------------------------------------------------------
# hybrid SpMM: plain versions on the CPU against the JAX kernels and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 41])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_hybrid_plain_matches_jax_and_oracle(hub, k, direction):
    tg, jg = hub
    g, j = (tg, jg) if direction == "fwd" else (tg.transpose(),
                                                 jg.transpose())
    thr = 128
    tiled = build_tiling(tg, dense_threshold=thr)
    plan = tiled.fwd if direction == "fwd" else tiled.bwd
    x = np.random.default_rng(k).normal(size=(g.num_cols, k)).astype(
        np.float32)
    got = spmm_hybrid(plan, _t(x)).numpy()

    row, col, val = _host_coo(g)
    jplan = build_plan_v5_arrays(row, col, val, g.num_rows, g.num_cols,
                                 rb=128, k=k, dense_threshold=thr, S=2, g=4)
    assert 0 < jplan.dense_edges < g.nnz  # both halves exercised
    if direction == "fwd":
        assert int((plan.seg_row == 300).sum()) == 3  # the split hub row
        assert not got[301].any()  # the empty row
    want_jax = np.asarray(spmm_hybrid_v5(jplan, jnp.asarray(x)))
    oracle = np.asarray(xla_backend.spmm_raw(
        j.row, j.col, j.value, j.deg, jnp.asarray(x), j.num_rows, "sum"))
    assert got.shape == (g.num_rows, k)
    assert_close_bf16(got, want_jax)
    assert_close_bf16(got, oracle)


@pytest.mark.parametrize("k", [32, 41])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_k1_oracle_matches_xla(hub, k, direction):
    """The float64 oracle that K1 is held to on a card (``out`` plus the
    plan's residual edges times x) against the JAX package's XLA SpMM of
    the same residual edges plus the same ``out``, fp32 there (1e-5 of
    the scale: only the rounding and sum order differ)."""
    tg, _ = hub
    tiled = build_tiling(tg, dense_threshold=128)
    plan = tiled.fwd if direction == "fwd" else tiled.bwd
    assert plan.sparse_edges > 0
    rng = np.random.default_rng(k)
    x = rng.normal(size=(plan.num_cols, k)).astype(np.float32)
    out0 = rng.normal(size=(plan.num_rows, k)).astype(np.float32)
    out = _t(out0)
    got = spmm_stream_oracle(plan, _t(x), out)
    assert got.dtype == torch.float64 and torch.equal(out, _t(out0))
    rows = np.repeat(np.arange(plan.num_rows),
                     np.diff(plan.res_rowptr.numpy()))
    want = out0 + np.asarray(xla_backend.spmm_raw(
        jnp.asarray(rows, jnp.int32), jnp.asarray(plan.res_col.numpy()),
        jnp.asarray(plan.res_val.numpy()), jnp.zeros(plan.num_rows),
        jnp.asarray(x), plan.num_rows, "sum"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gradcheck(reduce):
    rng = np.random.default_rng(4)
    g, _ = graphs(rng.integers(0, 12, 60), rng.integers(0, 9, 60),
                  rng.normal(size=60).astype(np.float32), 12, 9)
    x = torch.randn(9, 3, dtype=torch.float64, requires_grad=True)
    v = g.value.to(torch.float64).requires_grad_(True)

    def f(x, v):
        out = pt.SpMM.apply(g, pt.Reduce.of(reduce), "auto", x, v)
        return out

    assert torch.autograd.gradcheck(f, (x, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduce", REDUCES)
def test_grads_match_jax_grad(hub, reduce):
    tg, jg = hub
    rng = np.random.default_rng(5)
    x = rng.normal(size=(tg.num_cols, 8)).astype(np.float32)
    w = rng.normal(size=(tg.num_rows, 8)).astype(np.float32)

    def jloss(value, xx):
        graph = dataclasses.replace(jg, value=value)
        return jnp.sum(isplib_tpu.spmm(graph, xx, reduce, backend="xla") * w)

    jv_grad, jx_grad = jax.grad(jloss, argnums=(0, 1))(jg.value,
                                                        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    v = tg.value.clone().requires_grad_(True)
    out = pt.SpMM.apply(tg, pt.Reduce.of(reduce), "auto", xt, v)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx_grad),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jv_grad),
                               rtol=1e-5, atol=1e-5)
    assert bool((v.grad[tg.nnz:] == 0).all())


def test_grad_value_skipped_unless_required(hub):
    tg, _ = hub
    x = torch.randn(tg.num_cols, 4, requires_grad=True)
    out = pt.spmm(tg, x)
    out.sum().backward()
    assert x.grad is not None and tg.value.grad is None


def test_tiled_backward_uses_transpose_plan(hub):
    tg, _ = hub
    tiled = build_tiling(tg, dense_threshold=128)
    x = torch.randn(tg.num_cols, 32, requires_grad=True)
    w = torch.randn(tg.num_rows, 32)
    (pt.spmm(tiled, x) * w).sum().backward()
    want = reference.spmm_raw(tg.csc_row, tg.csc_col, tg.csc_value,
                              tg.deg_t, w, tg.num_cols, "sum")
    assert x.grad.shape == (tg.num_cols, 32)
    assert_close_bf16(x.grad.numpy(), want.numpy())


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_tiled_forward_matches_reference(hub, reduce):
    tg, _ = hub
    tiled = build_tiling(tg, dense_threshold=128)
    x = torch.randn(tg.num_cols, 41)
    assert_close_bf16(pt.spmm(tiled, x, reduce).numpy(),
                      pt.spmm(tiled, x, reduce, backend="reference").numpy())
