"""The port's SDDMM (K4's plain version over the CSR work list, the public
``sddmm`` and the sum/mean ``grad_value`` of ``spmm``) against the JAX
package: the XLA oracle ``sddmm_dot_raw``, the Pallas kernel
``sddmm_tiled`` in interpret mode and ``jax.grad``, within 1e-5 of the
output's scale (fp32 on both sides; only the order of the K-sum
differs)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isplib_tpu
import isplib_tpu_torch as pt
from isplib_tpu.kernels.sddmm_pallas import sddmm_tiled
from isplib_tpu.ops import xla_backend
from isplib_tpu.sparse.tiling_v2 import build_plan_v2_arrays
from isplib_tpu.utils.transfer import tree_device_put
from isplib_tpu_torch.kernels import sddmm as k4
from isplib_tpu_torch.sparse.tiling import build_tiling

N, M, E = 300, 280, 3000


def graphs(seed, num_rows=N, num_cols=M, nnz=E):
    """Rows num_rows-30.. empty; a third of the edges in two hub rows of
    several segments each; normal values."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, num_rows - 30, nnz)
    src = rng.integers(0, num_cols, nnz)
    hub = rng.random(nnz) < 0.35
    dst[hub] = rng.integers(0, 2, hub.sum())
    val = rng.normal(size=nnz).astype(np.float32)
    args = dict(num_nodes=num_rows, num_src_nodes=num_cols, edge_value=val,
                edge_multiple=128)
    ei = np.stack([src, dst])
    tg = pt.from_edge_index(ei, device="cpu", **args)
    return tg, build_tiling(tg), isplib_tpu.from_edge_index(ei, **args)


def operands(seed, k, num_rows=N, num_cols=M):
    rng = np.random.default_rng(seed + 50)
    return (rng.normal(size=(num_rows, k)).astype(np.float32),
            rng.normal(size=(num_cols, k)).astype(np.float32))


def assert_scaled(got, want, tol=1e-5):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def hub():
    return graphs(3)


def masked(jg, dots):
    return np.where(np.arange(jg.nnz_padded) < jg.nnz, np.asarray(dots), 0.0)


@pytest.mark.parametrize("k", [8, 16, 41])
def test_k4_plain_matches_xla_oracle(hub, k):
    tg, tt, jg = hub
    assert tt.fwd_mm.nsplit > 0
    a, b = operands(k, k)
    got = k4.sddmm(tt.fwd_mm, tg.col, torch.from_numpy(a),
                   torch.from_numpy(b))
    assert got.shape == (tg.nnz_padded,) and got.dtype == torch.float32
    want = masked(jg, xla_backend.sddmm_dot_raw(jg.row, jg.col,
                                                jnp.asarray(a),
                                                jnp.asarray(b)))
    assert_scaled(got.numpy(), want)
    assert not got[tg.nnz:].any()


@pytest.mark.parametrize("k", [8, 41])
def test_k4_plain_matches_jax_pallas_interpret(k):
    """Against the TPU kernel in interpret mode over its with-eids v2 plan
    (a small graph: interpret mode is slow)."""
    tg, tt, jg = graphs(4, num_rows=200, num_cols=180, nnz=1200)
    n = jg.nnz
    plan = tree_device_put(build_plan_v2_arrays(
        np.asarray(jg.row)[:n].astype(np.int64),
        np.asarray(jg.col)[:n].astype(np.int64), np.asarray(jg.value)[:n],
        200, 180, rb=128, ct=128, eb=128, k=k, with_eids=True))
    a, b = operands(k + 1, k, 200, 180)
    got = k4.sddmm(tt.fwd_mm, tg.col, torch.from_numpy(a),
                   torch.from_numpy(b))
    want = sddmm_tiled(plan, jnp.asarray(a), jnp.asarray(b), jg.nnz_padded)
    assert_scaled(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tiled", [True, False])
def test_public_sddmm_and_its_grads_match_jax(hub, tiled):
    tg, tt, jg = hub
    a, b = operands(1, 16)
    w = np.random.default_rng(2).normal(size=tg.nnz_padded).astype(
        np.float32)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = pt.sddmm(tt if tiled else tg, at, bt)
    (out * torch.from_numpy(w)).sum().backward()

    def loss(a_, b_):
        return jnp.sum(isplib_tpu.sddmm(jg, a_, b_) * w)

    want = np.asarray(isplib_tpu.sddmm(jg, jnp.asarray(a), jnp.asarray(b)))
    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    assert_scaled(out.detach().numpy(), want)
    assert not out[tg.nnz:].any()
    assert_scaled(at.grad.numpy(), np.asarray(ga))
    assert_scaled(bt.grad.numpy(), np.asarray(gb))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("k", [8, 41])
def test_spmm_grad_value_matches_jax_grad(hub, monkeypatch, reduce, k):
    """grad_value of sum/mean SpMM on a TiledGraph runs K4 (its plain
    version here) over fwd_mm; it and grad_x equal jax.grad of the JAX
    spmm on the XLA path."""
    tg, tt, jg = hub
    calls = []
    plain = k4.sddmm_plain
    monkeypatch.setattr(k4, "sddmm_plain",
                        lambda *args: calls.append(args[0]) or plain(*args))
    x = operands(5, k)[1]
    w = np.random.default_rng(6).normal(size=(N, k)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    v = tg.value.clone().requires_grad_(True)
    tiled = dataclasses.replace(tt, graph=tg.with_value(v))
    (pt.spmm(tiled, xt, reduce) * torch.from_numpy(w)).sum().backward()
    assert calls == [tt.fwd_mm]

    def loss(value, xx):
        return jnp.sum(isplib_tpu.spmm(jg.with_value(value), xx, reduce,
                                       backend="xla") * w)

    jv, jx = jax.grad(loss, argnums=(0, 1))(jg.value, jnp.asarray(x))
    assert_scaled(v.grad.numpy(), np.asarray(jv))
    assert_scaled(xt.grad.numpy(), np.asarray(jx), 2e-2)  # K2's bf16 blocks
    assert not v.grad[tg.nnz:].any()
    # a CSRGraph computes it with the plain formula: no K4
    v2 = tg.value.clone().requires_grad_(True)
    (pt.spmm(tg.with_value(v2), torch.from_numpy(x), reduce)
     * torch.from_numpy(w)).sum().backward()
    assert calls == [tt.fwd_mm]
    assert_scaled(v2.grad.numpy(), np.asarray(jv))


def test_k4_plain_is_chunked(hub, monkeypatch):
    """A graph whose (E, K) temporaries exceed the budget sums the
    chunks' partial dots: the same numbers within fp32 rounding."""
    from isplib_tpu_torch.ops import reference
    tg, tt, _ = hub
    a, b = (torch.from_numpy(t) for t in operands(7, 41))
    whole = k4.sddmm(tt.fwd_mm, tg.col, a, b)
    monkeypatch.setattr(reference, "CHUNK_BYTES", tg.nnz * 20 * 6)
    assert len(reference._chunks(tg.nnz, 41, 20)) == 7
    assert_scaled(k4.sddmm(tt.fwd_mm, tg.col, a, b).numpy(), whole.numpy(),
                  1e-6)


def test_k4_wrapper_rejects_bad_operands(hub):
    tg, tt, _ = hub
    a, b = (torch.from_numpy(t) for t in operands(1, 8))
    ok = (tt.fwd_mm, tg.col, a, b)

    def call(i, v):
        args = list(ok)
        args[i] = v
        return k4.sddmm(*args)

    call(0, tt.fwd_mm)
    with pytest.raises(ValueError):
        call(2, torch.zeros(N + 1, 8))
    with pytest.raises(ValueError):
        call(3, torch.zeros(M, 9))
    with pytest.raises(TypeError):
        call(2, a.double())
    with pytest.raises(TypeError):
        call(1, tg.col.long())
    with pytest.raises(ValueError):
        call(1, tg.col[:10])
    with pytest.raises(ValueError):
        call(3, torch.zeros(8, M).t())
    with pytest.raises(ValueError):
        call(2, torch.zeros(N, 8, device="meta"))
    before = k4.LAUNCHES
    call(0, tt.fwd_mm)
    assert k4.LAUNCHES == before  # a CPU tensor launches nothing
