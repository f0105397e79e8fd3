"""The port's sharded path (``isplib_tpu_torch.dist``) and its v2 kernels'
plain versions against the JAX package.

* partitions and v2 plans: every array and integer field equal; a
  partition that holds some shards (``hold``) equals those shards of the
  full one; ``tiling`` takes ``version`` and ``minmax`` only;
* K8's plain version within 1e-5 of the output's scale of the fp32 XLA
  reference (fp32, only the sum order differs) and within the bf16 contract
  (2e-2) of the interpret-mode Pallas K8, whose products are bf16;
* K7's plain version: values within 1e-6 and args exactly equal to the
  interpret-mode Pallas K7 and the XLA arg reference (exact fp32 on all
  sides), ties to the lowest edge id;
* ``spmm_sharded`` on ``LocalMesh(8)`` against JAX ``spmm_sharded`` on the
  8-device CPU mesh, forward and x-gradients: 1e-5 where both sides are
  fp32 (the reference route, max/min everywhere, and the port's fp32 tiled
  sum routes against JAX's reference route), the bf16 contract (2e-2 of
  the scale) against JAX's tiled sum routes;
* a GCN on a ShardedGraph with flax weights: loss within 1e-5 of JAX's;
* two processes over gloo through ``GroupMesh`` equal ``LocalMesh`` at
  1e-6 (the same kernels' plain versions on the same shards; only the
  exchange differs).

Run as a script (``python tests/test_torch_dist.py <rank> <port> <out>``)
it is one rank of the two-process test.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_coo(seed, n=300, nnz=2500):
    """Random COO without duplicates, (row, col)-sorted, normal values."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n, nnz),
                                rng.integers(0, n, nnz)]), axis=1)
    row, col = pairs
    return row, col, rng.normal(size=row.shape[0]).astype(np.float32), n


def ring(n=512):
    src = np.arange(n)
    return (src + 1) % n, src, None, n


# tilings of the three routes, at the shard plans' fixed geometry
ROUTES = {"reference": None, "v5": dict(version=5), "v2": dict(version=2)}


# ---------------------------------------------------------------------------
# Two-process worker (GroupMesh over gloo)
# ---------------------------------------------------------------------------

def _worker(rank: int, port: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from isplib_tpu_torch.dist import GroupMesh, partition_rows, spmm_sharded

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        row, col, val, n = make_coo(7)
        x = np.random.default_rng(8).normal(size=(n, 16)).astype(np.float32)
        w = np.random.default_rng(9).normal(size=(n, 16)).astype(np.float32)
        res = {}
        for route in ("reference", "v2"):
            sg = partition_rows(row, col, val, n, 2, edge_multiple=64,
                                halo_multiple=16, tiling=ROUTES[route],
                                device="cpu", hold=[rank])
            res[f"{route}-held"] = np.asarray(
                [*sg.held, sg.row_loc.shape[0], sg.send_ids.shape[0],
                 len(sg.plans or ()), len(sg.plans_mm or ())])
            rps = sg.rows_per_shard
            lo = rank * rps

            def rows(a):
                a = np.concatenate([a, np.zeros((2 * rps - n, 16),
                                                np.float32)])
                return torch.from_numpy(a[lo:lo + rps])

            for red in ("sum", "max"):
                xr = rows(x).requires_grad_(True)
                o = spmm_sharded(sg, xr, red, mesh=GroupMesh())
                (o * rows(w)).sum().backward()
                res[f"{route}-{red}-out"] = o.detach().numpy()
                res[f"{route}-{red}-grad"] = xr.grad.numpy()
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import isplib_tpu  # noqa: E402
import isplib_tpu.dist as jdist  # noqa: E402
import isplib_tpu.nn as jnn  # noqa: E402
from isplib_tpu.kernels.spmm_minmax import spmm_minmax_tiled  # noqa: E402
from isplib_tpu.dist.spmm_dist import set_mesh as jax_set_mesh  # noqa: E402
from isplib_tpu.kernels.spmm_pallas_v2 import spmm_tiled_v2  # noqa: E402
from isplib_tpu.ops import xla_backend  # noqa: E402
from isplib_tpu.sparse.tiling_v2 import (  # noqa: E402
    build_plan_v2_arrays as jax_build_plan_v2)
from isplib_tpu.train.loop import _loss_fn as jax_loss_fn  # noqa: E402

import isplib_tpu_torch as pt  # noqa: E402
from isplib_tpu_torch.data import sbm_dataset  # noqa: E402
from isplib_tpu_torch.dist import (LocalMesh, ShardedGraph,  # noqa: E402
                                   partition_rows, set_mesh, spmm_sharded)
from isplib_tpu_torch.kernels import spmm_minmax, spmm_v2  # noqa: E402
from isplib_tpu_torch.ops import reference  # noqa: E402
from isplib_tpu_torch.sparse.tiling_v2 import (  # noqa: E402
    TiledPlanV2, build_plan_v2_arrays)
from isplib_tpu_torch.train.loop import _loss_fn  # noqa: E402

ARRAYS = ("row_loc", "col_loc", "val_loc", "row_halo", "col_halo",
          "val_halo", "deg", "send_ids")
INTS = ("num_rows", "rows_per_shard", "halo", "num_shards", "nnz",
        "local_edges", "halo_edges")


@pytest.fixture(scope="module")
def mesh8():
    return Mesh(np.asarray(jax.devices()[:8]), ("data",))


def both_partitions(case, d, tiling=None):
    row, col, val, n = case
    kw = dict(edge_multiple=64, halo_multiple=16, tiling=tiling)
    return (partition_rows(row, col, val, n, d, device="cpu", **kw),
            jdist.partition_rows(row, col, val, n, d, device=False, **kw))


# ---------------------------------------------------------------------------
# Partition and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("graph", ["random", "ring"])
def test_partition_matches_jax(graph, d):
    case = make_coo(1, n=500, nnz=4000) if graph == "random" else ring()
    sg, jsg = both_partitions(case, d)
    for f in ARRAYS:
        want = np.asarray(getattr(jsg, f))
        got = getattr(sg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in INTS:
        assert getattr(sg, f) == getattr(jsg, f), f
    assert sg.local_edges + sg.halo_edges == sg.nnz
    if graph == "ring":
        assert sg.halo == 16  # one boundary row per pair, padded


def plan_fields_equal(p: TiledPlanV2, jp) -> None:
    for f in ("edges", "rb_locals", "cell_starts"):
        want = np.asarray(getattr(jp, f))
        got = getattr(p, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("rb", "ct", "eb", "nc", "nrb_s", "n_super", "num_rows",
              "num_cols", "kt", "gd", "nct", "nrb", "r_padded", "c_padded"):
        assert getattr(p, f) == getattr(jp, f), f
    assert p.fill == jp.fill


@pytest.mark.parametrize("case", ["eids", "eids-unsorted", "native",
                                  "numpy-route", "empty", "halo-space"])
def test_plan_v2_matches_jax(case):
    """``native``: the JAX package's default call on row-sorted edges
    without ids (its OpenMP build); ``numpy-route``: the same edges with
    ``orig_ids``, which forces its numpy build; ``halo-space``: more
    columns than rows, as a shard's halo plan has."""
    row, col, val, n = make_coo(2, n=600, nnz=6000)
    num_cols = n
    kw = dict(rb=128, ct=128, eb=128, k=16)
    extra = {}
    if case in ("eids", "eids-unsorted"):
        extra = dict(with_eids=True)
    if case == "eids-unsorted":
        o = np.random.default_rng(3).permutation(row.shape[0])
        row, col, val = row[o], col[o], val[o]
    if case == "numpy-route":
        extra = dict(orig_ids=np.arange(row.shape[0]))
    if case == "empty":
        row, col, val = row[:0], col[:0], val[:0]
        extra = dict(with_eids=True)
    if case == "halo-space":
        num_cols = 1040
        col = col * 2 % num_cols
        kw = dict(rb=128, ct=256, eb=256, k=41, vmem_out_bytes=1 << 20)
    p = build_plan_v2_arrays(row, col, val, n, num_cols, device="cpu",
                             **kw, **extra)
    jp = jax_build_plan_v2(row, col, val, n, num_cols, **kw, **extra)
    plan_fields_equal(p, jp)
    assert p.with_eids == (p.planes == 4)


@pytest.mark.parametrize("which", ["minmax", "v2"])
def test_shard_plans_match_jax_stacked(which):
    """Each shard's plan equals its part of the JAX package's stacked
    plan: the real chunks, and the cell ranges up to the last (which the
    stacking points at the common chunk count)."""
    route = "v2" if which == "v2" else "v5"
    sg, jsg = both_partitions(make_coo(4), 8, ROUTES[route])
    jplans = jsg.plans_mm if which == "minmax" else jsg.plans
    plans = sg.plans_mm if which == "minmax" else sg.plans
    for slot, jp in enumerate(jplans):
        for i in range(8):
            p = plans[i][slot]
            nc = p.nc
            assert int(p.cell_starts[-1]) == nc
            np.testing.assert_array_equal(
                p.edges[:nc].numpy(), np.asarray(jp.edges)[i, :nc])
            np.testing.assert_array_equal(
                p.rb_locals[:nc].numpy(), np.asarray(jp.rb_locals)[i, :nc])
            np.testing.assert_array_equal(
                p.cell_starts[:-1].numpy(),
                np.asarray(jp.cell_starts)[i, :-1])
            assert (p.nrb_s, p.n_super, p.num_rows, p.num_cols) == (
                jp.nrb_s, jp.n_super, jp.num_rows, jp.num_cols)


def test_v5_shard_plans_hold_every_edge():
    """The default route's per-shard HybridPlans hold each shard's local
    and halo edges, forward and transposed."""
    sg, _ = both_partitions(make_coo(4), 8, ROUTES["v5"])
    for i in range(8):
        sh = sg.shard(i)
        n_loc = int((sh.row_loc < sg.rows_per_shard).sum())
        n_halo = int((sh.row_halo < sg.rows_per_shard).sum())
        counts = [p.dense_edges + p.sparse_edges for p in sh.plans]
        assert counts == [n_loc, n_loc, n_halo, n_halo]
        assert sh.plans[2].num_cols == sg.num_shards * sg.halo


def same_plan(p, q) -> None:
    assert type(p) is type(q)
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(q, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("route", ["v5", "v2"])
def test_held_shards_equal_the_full_partition(route):
    """A process that holds some shards keeps exactly those shards' arrays
    and plans of the full partition, and nothing of the others."""
    row, col, val, n = make_coo(4)
    kw = dict(edge_multiple=64, halo_multiple=16, tiling=ROUTES[route],
              device="cpu")
    full = partition_rows(row, col, val, n, 8, **kw)
    part = partition_rows(row, col, val, n, 8, hold=[5, 2], **kw)
    assert part.held == (2, 5) and full.held == tuple(range(8))
    assert part.row_loc.shape[0] == len(part.plans) == len(part.plans_mm) == 2
    for f in INTS:
        assert getattr(part, f) == getattr(full, f), f
    for i in part.held:
        a, b = part.shard(i), full.shard(i)
        for f in ARRAYS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for p, q in zip(a.plans + a.plans_mm, b.plans + b.plans_mm):
            same_plan(p, q)
    with pytest.raises(ValueError, match="not held"):
        part.shard(0)
    with pytest.raises(ValueError, match="every shard"):
        spmm_sharded(part, torch.from_numpy(X), "sum", mesh=LocalMesh())
    with pytest.raises(ValueError, match="hold"):
        partition_rows(row, col, val, n, 8, hold=[8], **kw)


@pytest.mark.parametrize("tiling", [dict(verison=2), dict(version=2, eb=128),
                                    dict(dense_threshold=32), dict(version=3)])
def test_partition_rejects_other_tiling_options(tiling):
    """The shard plans' geometry is fixed: a key other than ``version`` and
    ``minmax``, or another version, raises instead of being dropped."""
    row, col, val, n = make_coo(4)
    with pytest.raises(ValueError, match="tiling"):
        partition_rows(row, col, val, n, 2, tiling=tiling, device="cpu")


# ---------------------------------------------------------------------------
# K8 and K7, plain versions
# ---------------------------------------------------------------------------

def plan_case(seed, k, with_eids, ties=False, n=600, nnz=6000):
    """CSR-ordered edges (a hub row and empty rows), their port and JAX
    plans, and x; ``ties``: unit/zero values and integer x."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n - 50, nnz)
    row[rng.random(nnz) < 0.1] = 7
    col = rng.integers(0, n, nnz)
    o = np.lexsort((col, row))
    row, col = row[o], col[o]
    if ties:
        val = np.where(rng.random(nnz) < 0.2, 0.0, 1.0).astype(np.float32)
        x = np.round(rng.normal(size=(n, k))).astype(np.float32)
    else:
        val = rng.normal(size=nnz).astype(np.float32)
        x = rng.normal(size=(n, k)).astype(np.float32)
    kw = dict(rb=128, ct=128, eb=128, k=k, with_eids=with_eids)
    return (row, col, val, n, x,
            build_plan_v2_arrays(row, col, val, n, n, device="cpu", **kw),
            jax_build_plan_v2(row, col, val, n, n, **kw))


@pytest.mark.parametrize("k", [8, 16])
def test_k8_plain_matches_xla(k):
    row, col, val, n, x, p, _ = plan_case(5, k, False)
    got = spmm_v2.spmm_v2(p, torch.from_numpy(x))
    g = isplib_tpu.from_edge_index(np.stack([col, row]), num_nodes=n,
                                   edge_value=val, edge_multiple=64)
    want = np.asarray(xla_backend.spmm_raw(g.row, g.col, g.value, g.deg,
                                           jnp.asarray(x), n, "sum"))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_k8_plain_matches_interpret_pallas():
    _, _, _, _, x, p, jp = plan_case(6, 16, False)
    got = spmm_v2.spmm_v2(p, torch.from_numpy(x)).numpy()
    want = np.asarray(spmm_tiled_v2(jp, jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("red", ["max", "min"])
def test_k7_plain_matches_interpret_pallas(red):
    _, _, _, n, x, p, jp = plan_case(7, 16, True)
    sentinel = 123456
    out, arg = spmm_minmax.spmm_minmax_v2(p, torch.from_numpy(x), red,
                                          sentinel)
    want, want_arg = spmm_minmax_tiled(jp, jnp.asarray(x), red, sentinel)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))
    assert bool((arg[n - 50:] == sentinel).all())  # the empty rows


@pytest.mark.parametrize("red", ["max", "min"])
def test_k7_plain_ties_go_to_the_lowest_id(red):
    """With unit and zero values and integer x products tie and ±0.0
    meet: the args equal the XLA arg reference's (lowest id), the values
    equal it as numbers, and out is sign·(sign·product + 0.0) of the
    winner, bit for bit."""
    row, col, val, n, x, p, _ = plan_case(8, 16, True, ties=True)
    g = isplib_tpu.from_edge_index(np.stack([col, row]), num_nodes=n,
                                   edge_value=val, edge_multiple=64)
    sentinel = g.nnz_padded - 1
    xt = torch.from_numpy(x)
    out, arg = spmm_minmax.spmm_minmax_v2(p, xt, red, sentinel)
    want, want_arg = xla_backend.spmm_arg_raw(
        g.row, g.col, g.value, g.deg, jnp.asarray(x), n,
        isplib_tpu.Reduce.of(red))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    hit = arg != sentinel
    a = arg.long().clamp(max=row.shape[0] - 1)
    prod = torch.from_numpy(val)[a] * xt[torch.from_numpy(col)[a],
                                         torch.arange(16).expand_as(a)]
    sign = -1.0 if red == "min" else 1.0
    want_bits = torch.where(hit, sign * (sign * prod + 0.0), 0.0)
    assert torch.equal(out.view(torch.int32), want_bits.view(torch.int32))


def test_v2_wrappers_reject_bad_operands_and_count_no_cpu_launch():
    _, _, _, n, x, p, _ = plan_case(9, 8, True)
    xt = torch.from_numpy(x)
    before = (spmm_v2.LAUNCHES, spmm_minmax.LAUNCHES)
    spmm_v2.spmm_v2(p, xt)
    spmm_minmax.spmm_minmax_v2(p, xt, "max", 0)
    assert (spmm_v2.LAUNCHES, spmm_minmax.LAUNCHES) == before
    with pytest.raises(TypeError):
        spmm_v2.spmm_v2(p, xt.double())
    with pytest.raises(ValueError):
        spmm_v2.spmm_v2(p, xt[1:])
    with pytest.raises(ValueError):
        spmm_v2.spmm_v2(p, torch.zeros(8, n).t())
    with pytest.raises(ValueError):
        spmm_v2.spmm_v2(p, torch.zeros(n, 8, device="meta"))
    with pytest.raises(ValueError):
        spmm_minmax.spmm_minmax_v2(p, xt, "sum", 0)
    no_ids = plan_case(9, 8, False)[5]
    with pytest.raises(ValueError, match="with_eids"):
        spmm_minmax.spmm_minmax_v2(no_ids, xt, "max", 0)


def test_empty_to_zero_keeps_the_identity():
    g = pt.from_edge_index(np.array([[0, 1], [1, 1]]), num_nodes=3,
                           edge_value=np.array([2.0, -1.0], np.float32),
                           edge_multiple=8, device="cpu")
    x = torch.tensor([[1.0], [3.0], [5.0]])
    args = (g.row, g.col, g.value, g.deg, x, 3)
    keep = reference.spmm_raw(*args, "max", empty_to_zero=False)
    assert keep[:, 0].tolist() == [float("-inf"), 2.0, float("-inf")]
    assert reference.spmm_raw(*args, "min", empty_to_zero=False)[
        :, 0].tolist() == [float("inf"), -3.0, float("inf")]
    assert reference.spmm_raw(*args, "max")[:, 0].tolist() == [0.0, 2.0,
                                                               0.0]


# ---------------------------------------------------------------------------
# spmm_sharded on LocalMesh(8) against JAX's 8-device mesh
# ---------------------------------------------------------------------------

SHARDED = make_coo(10)
N = SHARDED[3]
X = np.random.default_rng(11).normal(size=(N, 16)).astype(np.float32)
PROBE = np.random.default_rng(12).normal(size=(N, 16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_result(route, red, grad):
    """JAX spmm_sharded (8-device CPU mesh) of X, or its x-gradient of
    sum(out · PROBE)."""
    row, col, val, n = SHARDED
    jsg = jdist.partition_rows(row, col, val, n, 8, edge_multiple=64,
                               halo_multiple=16, tiling=ROUTES[route])
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))

    def f(x):
        return jdist.spmm_sharded(jsg, x, red, mesh=mesh)

    if grad:
        return np.asarray(jax.grad(lambda x: jnp.sum(f(x) * PROBE))(
            jnp.asarray(X)))
    return np.asarray(f(jnp.asarray(X)))


@functools.lru_cache(maxsize=None)
def port_partition(route):
    row, col, val, n = SHARDED
    return partition_rows(row, col, val, n, 8, edge_multiple=64,
                          halo_multiple=16, tiling=ROUTES[route],
                          device="cpu")


def port_result(route, red, grad):
    x = torch.from_numpy(X).requires_grad_(grad)
    out = spmm_sharded(port_partition(route), x, red, mesh=LocalMesh(8))
    assert out.shape == (N, 16)
    if not grad:
        return out.detach().numpy()
    (out * torch.from_numpy(PROBE)).sum().backward()
    return x.grad.numpy()


def close(got, want, bf16):
    scale = np.abs(want).max()
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_matches_jax(route, red):
    """Against JAX's route of the same partition; a tiled sum/mean (bf16
    on JAX's side) also against JAX's reference route at 1e-5, except the
    port's v5 route, whose dense half is bf16 too."""
    got = port_result(route, red, False)
    sum_like = red in ("sum", "mean")
    close(got, jax_result(route, red, False),
          bf16=sum_like and route != "reference")
    if sum_like and route == "v2":
        close(got, jax_result("reference", red, False), bf16=False)


@pytest.mark.parametrize("red", ["sum", "max"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_grad_matches_jax(route, red):
    got = port_result(route, red, True)
    if route == "v2" and red == "sum":  # the port's K8 is fp32
        close(got, jax_result("reference", red, True), bf16=False)
    else:
        close(got, jax_result(route, red, True),
              bf16=red == "sum" and route != "reference")


def test_sharded_matches_the_single_graph():
    row, col, val, n = SHARDED
    g = pt.from_edge_index(np.stack([col, row]), num_nodes=n,
                           edge_value=val, edge_multiple=64, device="cpu")
    x = torch.from_numpy(X)
    for red in ("sum", "mean", "max", "min"):
        want = pt.spmm(g, x, red).numpy()
        for route in ("reference", "v2"):
            close(port_result(route, red, False), want, bf16=False)


def test_tiled_tie_rule_matches_jax():
    """Unit values and integer x, so products tie across the local and the
    halo half of a row: the local half wins (JAX's strict ``b > a``), which
    the gradient shows, since it routes through the winning edge."""
    rng = np.random.default_rng(13)
    row, col, _, n = make_coo(14, n=200, nnz=2500)
    val = np.ones(row.shape[0], np.float32)
    x = np.round(rng.normal(size=(n, 8))).astype(np.float32)
    w = rng.normal(size=(n, 8)).astype(np.float32)
    tiling = ROUTES["v2"]
    sg, jsg = both_partitions((row, col, val, n), 8, tiling)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    for red in ("max",):
        jx = jnp.asarray(x)
        want = np.asarray(jdist.spmm_sharded(jsg, jx, red, mesh=mesh))
        want_g = np.asarray(jax.grad(lambda v: jnp.sum(
            jdist.spmm_sharded(jsg, v, red, mesh=mesh) * w))(jx))
        xt = torch.from_numpy(x).requires_grad_(True)
        out = spmm_sharded(sg, xt, red, mesh=LocalMesh())
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(), want)
        np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                                   atol=1e-6)


def test_tiled_routes_reject_value_gradients():
    sg = port_partition("v2")
    v = sg.val_loc.clone().requires_grad_(True)
    bad = dataclasses.replace(sg, val_loc=v)
    with pytest.raises(ValueError, match="tiling=None"):
        spmm_sharded(bad, torch.from_numpy(X), "sum")
    ref = dataclasses.replace(port_partition("reference"), val_loc=v)
    spmm_sharded(ref, torch.from_numpy(X), "sum").sum().backward()
    assert v.grad is not None


def test_spmm_dispatches_a_sharded_graph_through_the_mesh():
    sg = port_partition("v2")
    x = torch.from_numpy(X)
    before = spmm_v2.LAUNCHES
    for red in ("sum", "max"):
        assert torch.equal(pt.spmm(sg, x, red),
                           spmm_sharded(sg, x, red, mesh=LocalMesh(8)))
    assert spmm_v2.LAUNCHES == before  # CPU tensors: the plain versions
    with pytest.raises(ValueError, match="LocalMesh"):
        spmm_sharded(sg, x, "sum", mesh=LocalMesh(4))
    assert isinstance(sg, ShardedGraph) and sg.to("cpu") is sg
    assert sg.shard(3).send_ids.shape == (8, sg.halo)


def test_reference_backend_and_untiled_training_skip_the_plans(
        sbm_pair, monkeypatch):
    """``backend="reference"`` and ``tile=False`` run a ShardedGraph's
    reference route: with the tiled routes' kernels made to raise, both
    still run, and an unknown backend raises first."""
    from isplib_tpu_torch.dist import spmm_dist

    sg = port_partition("v2")
    x = torch.from_numpy(X)
    for red in ("sum", "max"):
        assert torch.equal(pt.spmm(sg, x, red, backend="reference"),
                           spmm_sharded(sg.without_plans(), x, red,
                                        mesh=LocalMesh(8)))
    with pytest.raises(ValueError, match="backend"):
        pt.spmm(sg, x, "sum", backend="kernels")

    def no_kernel(*args):
        raise AssertionError("a tiled route ran")

    monkeypatch.setattr(spmm_dist, "_run", no_kernel)
    monkeypatch.setattr(spmm_dist, "spmm_minmax_v2", no_kernel)
    with pytest.raises(AssertionError, match="tiled"):
        pt.spmm(sg, x, "sum")
    for red in ("sum", "max"):
        pt.spmm(sg, x, red, backend="reference")
    ds, _, _, port_sg = sbm_pair
    sds = dataclasses.replace(ds, graph=port_sg(ROUTES["v2"]))
    set_mesh(LocalMesh(8))
    try:
        res = pt.train_node_classifier(
            pt.GraphSAGE(16, hidden=16, num_classes=4, aggr="max",
                         device="cpu"), sds, epochs=2, device="cpu",
            tile=False)
    finally:
        set_mesh(None)
    assert np.all(np.isfinite(res.losses))


# ---------------------------------------------------------------------------
# Models on a ShardedGraph
# ---------------------------------------------------------------------------

SBM = dict(num_nodes=400, num_classes=4, num_features=16, avg_degree=8.0,
           homophily=0.9, noise=2.0, seed=1, edge_multiple=64)


@pytest.fixture(scope="module")
def sbm_pair():
    """The normalised SBM graph of tests/test_dist.py in both packages,
    partitioned 8 ways, and the port's dataset."""
    ds = sbm_dataset(device="cpu", **SBM)
    g = pt.gcn_norm(ds.graph, edge_multiple=64)
    n = g.nnz
    row, col, val = (g.row[:n].numpy(), g.col[:n].numpy(),
                     g.value[:n].numpy())
    kw = dict(edge_multiple=64, halo_multiple=16)
    return (ds, (row, col, val),
            jdist.partition_rows(row, col, val, 400, 8, **kw),
            lambda tiling: partition_rows(row, col, val, 400, 8, **kw,
                                          tiling=tiling, device="cpu"))


def test_sharded_gcn_loss_matches_flax(sbm_pair, mesh8):
    ds, _, jsg, port_sg = sbm_pair
    model = jnn.GCN(hidden=16, num_classes=4, dropout_rate=0.0)
    x = jnp.asarray(ds.x)
    jax_set_mesh(mesh8)
    try:
        params = model.init(jax.random.PRNGKey(0), jsg, x)["params"]
        logits = model.apply({"params": params}, jsg, x)
        want = float(jax_loss_fn(logits, jnp.asarray(ds.y),
                                 jnp.asarray(ds.train_mask), "nll"))
    finally:
        jax_set_mesh(None)
    m = pt.GCN(16, hidden=16, num_classes=4, dropout_rate=0.0, device="cpu")
    m.load_state_dict(pt.gcn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    for tiling in (None, ROUTES["v2"]):
        with torch.no_grad():
            got = float(_loss_fn(m(port_sg(tiling), torch.from_numpy(ds.x)),
                                 torch.from_numpy(ds.y),
                                 torch.from_numpy(ds.train_mask)))
        assert abs(got - want) <= 1e-5 * abs(want), (tiling, got, want)


def test_sharded_gcn_learns(sbm_pair):
    """30 epochs of GCN through the v2 route (K8 and K7's plain versions
    on the CPU) on the default mesh reach the JAX test's accuracy."""
    ds, _, _, port_sg = sbm_pair
    sds = dataclasses.replace(ds, graph=port_sg(ROUTES["v2"]))
    set_mesh(LocalMesh(8))
    try:
        res = pt.train_node_classifier(
            pt.GCN(16, hidden=16, num_classes=4, dropout_rate=0.0,
                   device="cpu"), sds, epochs=30, device="cpu")
    finally:
        set_mesh(None)
    assert res.losses[-1] < res.losses[0]
    assert res.test_acc > 0.7, res.test_acc


# ---------------------------------------------------------------------------
# GroupMesh across two processes, and the import rule
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(240)
def test_group_mesh_two_processes_match_local_mesh(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in (0, 1)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=200)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two-process run timed out")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-3000:]
    ranks = [np.load(o) for o in outs]
    for r, got in enumerate(ranks):  # each rank holds its own shard only
        assert got["reference-held"].tolist() == [r, 1, 1, 0, 0]
        assert got["v2-held"].tolist() == [r, 1, 1, 1, 1]

    row, col, val, n = make_coo(7)
    x = np.random.default_rng(8).normal(size=(n, 16)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=(n, 16)).astype(np.float32)
    for route in ("reference", "v2"):
        sg = partition_rows(row, col, val, n, 2, edge_multiple=64,
                            halo_multiple=16, tiling=ROUTES[route],
                            device="cpu")
        assert sg.halo_edges > 0
        for red in ("sum", "max"):
            xt = torch.from_numpy(x).requires_grad_(True)
            o = spmm_sharded(sg, xt, red, mesh=LocalMesh(2))
            (o * torch.from_numpy(w)).sum().backward()
            for what, want in (("out", o.detach().numpy()),
                               ("grad", xt.grad.numpy())):
                got = np.concatenate([r[f"{route}-{red}-{what}"]
                                      for r in ranks])[:n]
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{route} {red} {what}")


def test_dist_imports_no_jax():
    code = ("import sys; import isplib_tpu_torch.dist, "
            "isplib_tpu_torch.kernels.spmm_v2, "
            "isplib_tpu_torch.kernels.spmm_minmax; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'isplib_tpu.')) or m == 'isplib_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
