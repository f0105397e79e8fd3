"""The port's plan generations 1-5 against the JAX package.

* v1 (``TiledPlan``) and v3 (``HybridPlanV3``) plans equal JAX's array for
  array, bf16 blocks bit for bit, against both of JAX's builds: its numpy
  build (``native.available`` patched to False) and its native OpenMP
  build, which agree on the row-sorted arrays a graph passes;
* K10's plain version against the interpret-mode Pallas ``spmm_tiled`` in
  fp32 at HIGHEST precision (1e-5 of the scale: fp32 on both sides, only
  the sum order differs);
* K9's plain version against the interpret-mode Pallas ``spmm_bsr``, and
  the v3 hybrid against the JAX hybrid's two halves (1e-5 of the scale:
  both round x to bf16, so only the sum order differs); against JAX's own
  ``spmm_hybrid``, whose residual kernel rounds products to bf16, within
  the bf16 contract;
* ``spmm`` through a TiledGraph of each version, sum and mean, forward,
  ``grad_x`` and ``grad_value``, against JAX's XLA path and ``jax.grad``:
  1e-5 for the fp32 versions 1, 2 and 4, the bf16 contract (rtol 2e-2,
  atol 2e-2·max|ref|) for versions 3 and 5, whose dense blocks are bf16;
* K9's, K10's and K8's schedules against a numpy recount from the JAX
  plan's own arrays (members, row blocks, block columns, pieces; slot
  order, row pointers, work items, chunk offsets, zeroed rows) and K2's
  against its plan's ``blk_rowptr``, and a plain walk over each against
  the kernels' plain versions (1e-5 of the scale, with forced small pieces
  and items too) and the interpret-mode Pallas kernels (1e-5 of the
  scale; K2's walk with the residual half against JAX's
  ``spmm_hybrid_v5`` within the bf16 contract), on a hub case with a
  split row block, a split row and an empty row block; the derivation
  sites (versions 2, 3 and 5, the sharded routes; K7's for with-eids
  plans, K3's for ``fwd_mm``);
* the max/min walk of K3 and K7 (``minmax_sched.py``): a recount of each
  schedule (items, split and empty rows) and a plain walk over it, with
  the kernels' tie rule, equal to the plain versions bit for bit and to
  the interpret-mode Pallas kernels (values 1e-6, args exactly), on a
  graph with a dense corner, a hub row, empty rows, value-0 edges, ties
  on rounded x and ±0.0 products (K7's ids out of slot order);
* a forward-only tiling runs the reference transpose path for ``grad_x``;
  ``build_tiling`` rejects keys foreign to a version; ``tiling=`` on graph
  construction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import isplib_tpu
import isplib_tpu.native as jax_native
import isplib_tpu_torch as pt
from isplib_tpu.kernels.spmm_bsr import spmm_bsr as jax_spmm_bsr
from isplib_tpu.kernels.spmm_bsr import spmm_hybrid as jax_spmm_hybrid
from isplib_tpu.kernels.spmm_bsr2 import spmm_hybrid_v5 as jax_spmm_hybrid_v5
from isplib_tpu.kernels.spmm_pallas import spmm_tiled as jax_spmm_tiled
from isplib_tpu.kernels.spmm_pallas_v2 import spmm_tiled_v2
from isplib_tpu.sparse.graph import _build_arrays as jax_build_arrays
from isplib_tpu.sparse.tiling import _build_plan_arrays as jax_build_v1
from isplib_tpu.sparse.tiling import \
    build_tiling_from_numpy as jax_build_tiling
from isplib_tpu.sparse.tiling_v2 import build_plan_v2_arrays as jax_build_v2
from isplib_tpu.sparse.tiling_v3 import build_plan_v3_arrays as jax_build_v3
from isplib_tpu.sparse.tiling_v5 import build_plan_v5_arrays as jax_build_v5
from isplib_tpu_torch.dist import partition_rows
from isplib_tpu_torch.kernels import spmm_hybrid
from isplib_tpu_torch.kernels.spmm_bsr import spmm_bsr_plain
from isplib_tpu_torch.kernels.spmm_bsr_v3 import spmm_bsr_v3_plain
from isplib_tpu_torch.kernels.spmm_rowblock import spmm_rowblock_plain
from isplib_tpu_torch.kernels.spmm_stream import spmm_stream_plain
from isplib_tpu_torch.kernels.spmm_v2 import spmm_v2_plain
from isplib_tpu_torch.sparse import tiling, tiling_v2, tiling_v3, tiling_v5
from isplib_tpu_torch.sparse.tiling import (TiledGraph, TiledPlan,
                                            build_plan_v1_arrays,
                                            build_tiling)
from isplib_tpu_torch.sparse.tiling_v2 import (ITEM_SLOTS, TiledPlanV2,
                                               build_plan_v2_arrays)
from isplib_tpu_torch.sparse.tiling_v3 import (HybridPlanV3,
                                               build_plan_v3_arrays)
from isplib_tpu_torch.sparse.tiling_v5 import HybridPlan, build_hybrid_plan


def coo(seed=0, num_rows=700, num_cols=650, nnz=9000):
    """Half the edges in a 300x260 corner (blocks above the thresholds),
    half uniform, 500 duplicated edges; CSR-sorted, as a graph passes
    them."""
    rng = np.random.default_rng(seed)
    h = nnz // 2
    row = np.concatenate([rng.integers(0, 300, h),
                          rng.integers(0, num_rows, nnz - h)])
    col = np.concatenate([rng.integers(0, 260, h),
                          rng.integers(0, num_cols, nnz - h)])
    row = np.concatenate([row, row[:500]])
    col = np.concatenate([col, col[:500]])
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    order = np.lexsort((col, row))
    return row[order], col[order], val[order], num_rows, num_cols


@pytest.fixture(params=["numpy", "native"])
def jax_build_kind(request, monkeypatch):
    """Which of the JAX package's two plan builds the port is held to."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        assert jax_native.available()
    return request.param


def equal_arrays(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, name
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def v1_equal(p: TiledPlan, jp) -> None:
    for f in ("edges", "rb_ids", "ct_ids", "chunk_starts"):
        equal_arrays(getattr(p, f), getattr(jp, f), f)
    for f in ("rb", "ct", "eb", "nc", "num_rows", "num_cols", "nrb",
              "r_padded", "c_padded"):
        assert getattr(p, f) == getattr(jp, f), f
    assert p.fill == jp.fill


def v3_equal(p: HybridPlanV3, jp) -> None:
    assert (p.bsr is None) == (jp.bsr is None)
    if p.bsr is not None:
        b, jb = p.bsr, jp.bsr
        assert b.blocks.dtype == torch.bfloat16
        equal_arrays(b.blocks.view(torch.int16),
                     np.asarray(jb.blocks).view(np.int16), "blocks")
        for f in ("rb_locals", "cell_starts"):
            equal_arrays(getattr(b, f), getattr(jb, f), f)
        for f in ("nb", "nrb_s", "n_super", "num_rows", "num_cols", "kt",
                  "g", "n_bc", "n_br", "r_padded", "c_padded"):
            assert getattr(b, f) == getattr(jb, f), f
    assert (p.residual is None) == (jp.residual is None)
    if p.residual is not None:
        r, jr = p.residual, jp.residual
        for f in ("edges", "rb_locals", "cell_starts"):
            equal_arrays(getattr(r, f), getattr(jr, f), f"residual.{f}")
        for f in ("rb", "ct", "eb", "nc", "nrb_s", "n_super", "kt", "gd"):
            assert getattr(r, f) == getattr(jr, f), f
    for f in ("num_rows", "num_cols", "dense_edges", "sparse_edges", "nc",
              "fill"):
        assert getattr(p, f) == getattr(jp, f), f


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [(256, 512, 512), (128, 128, 128),
                                      (64, 64, 256)])
def test_plan_v1_matches_jax(jax_build_kind, geometry):
    row, col, val, r, c = coo()
    v1_equal(build_plan_v1_arrays(row, col, val, r, c, *geometry,
                                  device="cpu"),
             jax_build_v1(row, col, val, r, c, *geometry))


@pytest.mark.parametrize("case", ["empty-row-blocks", "no-edges"])
def test_plan_v1_pads_row_blocks_without_edges(case, monkeypatch):
    """Each row block without edges gets one all-pad chunk (JAX's numpy
    build, the one that takes an empty edge list)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    row, col, val, r, c = coo()
    keep = row < (200 if case == "empty-row-blocks" else 0)
    row, col, val = row[keep], col[keep], val[keep]
    p = build_plan_v1_arrays(row, col, val, r, c, 128, 128, 128,
                             device="cpu")
    v1_equal(p, jax_build_v1(row, col, val, r, c, 128, 128, 128))
    per_block = p.chunk_starts.diff()
    assert bool((per_block >= 1).all())
    assert p.nc == int(per_block.sum())


V3_CASES = {
    "tuner-g4": dict(rb=256, ct=128, eb=512, dense_threshold=8, g=4, k=32),
    "supers": dict(rb=128, ct=128, eb=128, dense_threshold=20, g=2, k=41,
                   vmem_out_bytes=1 << 15),
    "all-dense": dict(rb=128, ct=128, eb=128, dense_threshold=1, g=8, k=8),
}


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_plan_v3_matches_jax(jax_build_kind, case):
    row, col, val, r, c = coo()
    kw = V3_CASES[case]
    p = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    v3_equal(p, jax_build_v3(row, col, val, r, c, **kw))
    assert p.bsr is not None
    assert (p.residual is None) == (case == "all-dense")
    assert (p.bsr.n_super > 1) == (case == "supers")


def test_plan_v3_byte_cap_doubles_the_threshold(monkeypatch):
    """Where more blocks qualify than the cap holds, the threshold doubles
    until they fit, as JAX's ``max_block_bytes`` does."""
    row, col, val, r, c = coo()
    kw = dict(rb=128, ct=128, eb=128, dense_threshold=2, g=2, k=32)
    free = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    cap = (free.bsr.nb // 3) * 128 * 128 * 2
    monkeypatch.setattr(tiling_v3, "MAX_BLOCK_BYTES", cap)
    p = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    v3_equal(p, jax_build_v3(row, col, val, r, c, max_block_bytes=cap,
                             **kw))
    assert 0 < p.dense_edges < free.dense_edges


@pytest.mark.parametrize("version", [1, 2, 3])
def test_build_tiling_matches_jax_default_geometry(version):
    """``build_tiling(g, version=v)`` builds JAX's
    ``build_tiling_from_numpy(..., version=v)`` plans for A and Aᵀ (the
    row block, column tile and chunk default to 256, 512 and 512)."""
    row, col, val, r, c = coo(1)
    ei = np.stack([col, row])
    g = pt.from_edge_index(ei, num_nodes=r, num_src_nodes=c, edge_value=val,
                           edge_multiple=128, device="cpu")
    jarrays = jax_build_arrays(row, col, val, r, c, 128)
    jg = isplib_tpu.from_edge_index(ei, num_nodes=r, num_src_nodes=c,
                                    edge_value=val, edge_multiple=128)
    kw = {3: dict(dense_threshold=16, g=4)}.get(version, {})
    tiled = build_tiling(g, version=version, k=41, **kw)
    jtiled = jax_build_tiling(jg, jarrays, version=version, k=41,
                              device=False, **kw)
    for p, jp in ((tiled.fwd, jtiled.fwd), (tiled.bwd, jtiled.bwd)):
        if version == 1:
            v1_equal(p, jp)
        elif version == 3:
            v3_equal(p, jp)
        else:
            for f in ("edges", "rb_locals", "cell_starts"):
                equal_arrays(getattr(p, f), getattr(jp, f), f)
            assert (p.rb, p.ct, p.eb) == (jp.rb, jp.ct, jp.eb) == (256, 512,
                                                                   512)


# ---------------------------------------------------------------------------
# the kernels' plain versions against interpret-mode Pallas
# ---------------------------------------------------------------------------

def scale_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("k", [8, 41])
def test_rowblock_plain_matches_pallas(k):
    row, col, val, r, c = coo(2)
    p = build_plan_v1_arrays(row, col, val, r, c, 128, 128, 256,
                             device="cpu")
    jp = jax_build_v1(row, col, val, r, c, 128, 128, 256)
    x = np.random.default_rng(3).normal(size=(c, k)).astype(np.float32)
    want = jax_spmm_tiled(jp, jnp.asarray(x), compute_dtype=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    scale_close(spmm_rowblock_plain(p, torch.from_numpy(x)), want, 1e-5)


@pytest.mark.parametrize("k", [8, 41])
def test_bsr_v3_plain_matches_pallas(k):
    row, col, val, r, c = coo(4)
    kw = dict(rb=128, ct=128, eb=128, dense_threshold=16, g=4, k=k,
              vmem_out_bytes=1 << 15)  # several superblocks
    p = build_plan_v3_arrays(row, col, val, r, c, device="cpu", **kw)
    jp = jax_build_v3(row, col, val, r, c, **kw)
    assert p.bsr.n_super > 1 and p.residual is not None
    x = np.random.default_rng(5).normal(size=(c, k)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    scale_close(spmm_bsr_v3_plain(p.bsr, xt), jax_spmm_bsr(jp.bsr, xj), 1e-5)
    # the whole hybrid: JAX's two halves with its residual kernel in fp32,
    # and JAX's own spmm_hybrid (bf16 residual products) within the contract
    hybrid = spmm_hybrid.run_plan(p, xt)
    scale_close(hybrid, jax_spmm_bsr(jp.bsr, xj) + spmm_tiled_v2(
        jp.residual, xj, compute_dtype=jnp.float32), 1e-5)
    scale_close(hybrid, jax_spmm_hybrid(jp, xj), 2e-2)


# ---------------------------------------------------------------------------
# spmm through a TiledGraph of each version
# ---------------------------------------------------------------------------

VERSION_KW = {1: dict(rb=128, ct=128, eb=256),
              2: dict(rb=128, ct=128, eb=256),
              3: dict(rb=128, ct=128, eb=256, dense_threshold=16, g=4),
              4: {},
              5: dict(dense_threshold=16)}
PLAN_TYPE = {1: TiledPlan, 2: TiledPlanV2, 3: HybridPlanV3, 4: HybridPlan,
             5: HybridPlan}


@pytest.fixture(scope="module")
def pair():
    row, col, val, r, c = coo(6, num_rows=600, num_cols=600)
    ei = np.stack([col, row])
    kw = dict(num_nodes=r, num_src_nodes=c, edge_value=val,
              edge_multiple=128)
    return (pt.from_edge_index(ei, device="cpu", **kw),
            isplib_tpu.from_edge_index(ei, **kw))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_spmm_versions_match_jax(pair, version, reduce):
    g, jg = pair
    tiled = build_tiling(g, version=version, k=16, **VERSION_KW[version])
    assert isinstance(tiled.fwd, PLAN_TYPE[version])
    assert isinstance(tiled.bwd, PLAN_TYPE[version])
    if version == 4:
        assert tiled.fwd.nb == 0
    rng = np.random.default_rng(7)
    x = rng.normal(size=(g.num_cols, 16)).astype(np.float32)
    w = rng.normal(size=(g.num_rows, 16)).astype(np.float32)

    def jloss(value, xx):
        graph = dataclasses.replace(jg, value=value)
        out = isplib_tpu.spmm(graph, xx, reduce, backend="xla")
        return jnp.sum(out * w), out

    (_, jout), (jv_grad, jx_grad) = (
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jg.value, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    v = g.value.clone().requires_grad_(True)
    out = pt.SpMM.apply(tiled, pt.Reduce.of(reduce), "auto", xt, v)
    (out * torch.from_numpy(w)).sum().backward()
    rel = 2e-2 if version in (3, 5) else 1e-5
    scale_close(out.detach(), jout, rel)
    scale_close(xt.grad, jx_grad, rel)
    scale_close(v.grad, jv_grad, 1e-5)  # grad_value: K4's plain version
    assert bool((v.grad[g.nnz:] == 0).all())


@pytest.mark.parametrize("version", [1, 2, 3, 5])
def test_forward_only_tiling_runs_reference_transpose(pair, version,
                                                      monkeypatch):
    """``bwd`` None: ``grad_x`` runs the reference transpose path, never a
    plan (the forward plan would compute spmm(A, g))."""
    g, jg = pair
    tiled = build_tiling(g, version=version, k=16, build_backward=False,
                         **VERSION_KW[version])
    assert tiled.bwd is None

    def no_plan(*args):
        raise AssertionError("grad_x ran a plan")

    monkeypatch.setattr(spmm_hybrid, "spmm_transpose_sum", no_plan)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(g.num_cols, 16)).astype(np.float32)
    w = rng.normal(size=(g.num_rows, 16)).astype(np.float32)
    jx_grad = jax.grad(lambda xx: jnp.sum(isplib_tpu.spmm(
        jg, xx, "sum", backend="xla") * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (pt.spmm(tiled, xt) * torch.from_numpy(w)).sum().backward()
    scale_close(xt.grad, jx_grad, 1e-5)


@pytest.mark.parametrize("version, key", [
    (1, "dense_threshold"), (1, "g"), (2, "dense_threshold"), (2, "g"),
    (3, "S"), (4, "dense_threshold"), (5, "rb"), (5, "S"), (5, "g"),
    (5, "gd")])
def test_build_tiling_rejects_foreign_keys(pair, version, key):
    with pytest.raises(ValueError, match=key):
        build_tiling(pair[0], version=version, **{key: 8})


@pytest.mark.parametrize("version", [0, 6])
def test_build_tiling_rejects_unknown_versions(pair, version):
    with pytest.raises(ValueError, match="version"):
        build_tiling(pair[0], version=version)


@pytest.mark.parametrize("how", ["edge_index", "scipy"])
def test_graph_construction_builds_the_tiling(how):
    row, col, val, r, c = coo(9)
    tiling = dict(version=1, rb=128, ct=128, eb=128)
    if how == "edge_index":
        kw = dict(num_nodes=r, num_src_nodes=c, edge_value=val,
                  edge_multiple=128, device="cpu")
        tiled = pt.from_edge_index(np.stack([col, row]), tiling=tiling, **kw)
        plain = pt.from_edge_index(np.stack([col, row]), **kw)
    else:
        mat = sp.coo_matrix((val, (row, col)), shape=(r, c))
        tiled = pt.from_scipy(mat, edge_multiple=128, device="cpu",
                              tiling=tiling)
        plain = pt.from_scipy(mat, edge_multiple=128, device="cpu")
    assert isinstance(tiled, TiledGraph)
    want = build_tiling(plain, **tiling)
    for f in ("fwd", "bwd"):
        for name in ("edges", "rb_ids", "ct_ids", "chunk_starts"):
            assert torch.equal(getattr(getattr(tiled, f), name),
                               getattr(getattr(want, f), name))
    with pytest.raises(TypeError):
        pt.from_scipy(mat if how == "scipy" else sp.eye(4), device="cpu",
                      tiling=(128, 128, 128))


# ---------------------------------------------------------------------------
# the kernels' schedules (K9's pieces, K10's row order) against a numpy
# recount from the JAX plan's own arrays, and a plain walk over each
# ---------------------------------------------------------------------------

def hub_coo():
    """Row block 0 dense over 40 block columns (a hub row block of more
    members than a K9 piece takes), row 3 a hub row of 700 edges (more
    slots than a K10 work item takes), a few uniform edges, and rows
    256-383 without edges (an empty row block)."""
    rng = np.random.default_rng(11)
    num_rows, num_cols = 640, 5120
    row = np.concatenate([rng.integers(0, 128, 40 * 24),
                          rng.integers(0, num_rows, 900), np.full(700, 3)])
    col = np.concatenate([np.repeat(np.arange(40) * 128, 24)
                          + rng.integers(0, 128, 40 * 24),
                          rng.integers(0, num_cols, 900),
                          rng.integers(0, num_cols, 700)])
    keep = (row < 256) | (row >= 384)
    row, col = row[keep], col[keep]
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    order = np.lexsort((col, row))
    return row[order], col[order], val[order], num_rows, num_cols


SCHEDULE_V3_CASES = {**V3_CASES,
                     "hub": dict(rb=128, ct=128, eb=128, dense_threshold=12,
                                 g=4, k=32, vmem_out_bytes=1 << 16)}


def v3_case(case):
    row, col, val, r, c = hub_coo() if case == "hub" else coo()
    return (row, col, val, r, c), SCHEDULE_V3_CASES[case]


def v3_recount(jb):
    """(row block, block column, member) of every real member of a JAX
    BSRPlan, by the rule K9's first form used: a cell's members are
    real up to the first whose rb_local does not rise."""
    rbl, cs, g = np.asarray(jb.rb_locals), np.asarray(jb.cell_starts), jb.g
    n_bc = -(-jb.num_cols // 128)
    real = []
    for cell in range(cs.shape[0] - 1):
        s, bc = divmod(cell, n_bc)
        lo, hi = int(cs[cell]) * g, int(cs[cell + 1]) * g
        for m in range(lo, hi):
            if m > lo and rbl[m] <= rbl[m - 1]:
                break
            real.append((s * jb.nrb_s + int(rbl[m]), bc, m))
    return sorted(real)


@pytest.mark.parametrize("case", sorted(SCHEDULE_V3_CASES))
def test_v3_schedule_matches_a_recount(case):
    """Members, row blocks, block columns and order from the JAX plan's
    arrays; pieces cover every real member once, within one row block,
    at most PIECE_MEMBERS each, longest first; zeroed row blocks."""
    args, kw = v3_case(case)
    p = build_plan_v3_arrays(*args, device="cpu", **kw).bsr
    jb = jax_build_v3(*args, **kw).bsr
    s = p.sched
    want = v3_recount(jb)
    members = s.members.numpy()
    rblock = {m: rb for rb, _, m in want}
    got = [(rblock[m], bc, m) for m, bc in members]
    assert got == want
    pieces = s.pieces.numpy()
    covered = np.concatenate([np.arange(a, b) for a, b, _, _ in pieces])
    np.testing.assert_array_equal(np.sort(covered), np.arange(len(want)))
    sizes = pieces[:, 1] - pieces[:, 0]
    assert sizes.min() >= 1 and sizes.max() <= tiling_v3.PIECE_MEMBERS
    assert (np.diff(sizes) <= 0).all()
    cnt = np.bincount([rb for rb, _, _ in want], minlength=p.n_br)
    for a, b, rb, split in pieces:
        assert {x[0] for x in got[a:b]} == {rb}
        assert split == (cnt[rb] > tiling_v3.PIECE_MEMBERS)
    n_pieces = -(-cnt // tiling_v3.PIECE_MEMBERS)
    assert n_pieces.sum() == pieces.shape[0]
    np.testing.assert_array_equal(
        s.zero_rbs.numpy(),
        np.flatnonzero((cnt == 0) | (cnt > tiling_v3.PIECE_MEMBERS)))
    if case == "hub":
        assert pieces[:, 3].any() and (cnt == 0).any()


@pytest.mark.parametrize("piece_members", [0, 65])
def test_v3_schedule_rejects_pieces_k9_cannot_hold(piece_members):
    """K9 keeps a piece's member list in shared memory: 1 to 64."""
    args, kw = v3_case("hub")
    p = build_plan_v3_arrays(*args, device="cpu", **kw).bsr
    with pytest.raises(ValueError, match="piece_members"):
        tiling_v3.derive_bsr_schedule(p, piece_members=piece_members)
    s = tiling_v3.derive_bsr_schedule(p, piece_members=64)
    assert int((s.pieces[:, 1] - s.pieces[:, 0]).max()) <= 64


def walk_v3(plan, x):
    """K9's walk in plain PyTorch: each piece sums its members' bf16 blocks
    times the bf16-rounded x tiles of their block columns, in fp32, and
    adds the sum into its row block."""
    s, g, k = plan.sched, plan.g, x.shape[1]
    xb = x.new_zeros(plan.c_padded, k)
    xb[: plan.num_cols] = x.to(torch.bfloat16).float()
    out = x.new_zeros(plan.n_br * 128, k)
    for a, b, rb, _ in s.pieces.tolist():
        acc = x.new_zeros(128, k)
        for m, bc in s.members[a:b].tolist():
            blk = plan.blocks[m // g, :, (m % g) * 128:(m % g + 1) * 128]
            acc += blk.float().t() @ xb[bc * 128:(bc + 1) * 128]
        out[rb * 128:(rb + 1) * 128] += acc
    return out[: plan.num_rows]


@pytest.mark.parametrize("case", sorted(SCHEDULE_V3_CASES))
def test_v3_schedule_walk_matches_plain_version(case):
    args, kw = v3_case(case)
    p = build_plan_v3_arrays(*args, device="cpu", **kw).bsr
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(p.num_cols, 24)).astype(np.float32))
    scale_close(walk_v3(p, x), spmm_bsr_v3_plain(p, x), 1e-5)


def test_v3_schedule_walk_matches_pallas():
    """The hub case, whose row block 0 is split and row block 2 empty,
    against the interpret-mode Pallas ``spmm_bsr``."""
    args, kw = v3_case("hub")
    p = build_plan_v3_arrays(*args, device="cpu", **kw).bsr
    jb = jax_build_v3(*args, **kw).bsr
    x = np.random.default_rng(13).normal(size=(p.num_cols, 8)).astype(
        np.float32)
    scale_close(walk_v3(p, torch.from_numpy(x)),
                jax_spmm_bsr(jb, jnp.asarray(x)), 1e-5)


V1_SCHEDULE_CASES = {"256-512-512": ("coo", (256, 512, 512)),
                     "128-128-128": ("coo", (128, 128, 128)),
                     "64-64-256": ("coo", (64, 64, 256)),
                     "hub": ("hub", (128, 256, 256))}


def v1_case(case):
    graph, geometry = V1_SCHEDULE_CASES[case]
    return (hub_coo() if graph == "hub" else coo()), geometry


def v1_recount(jp):
    """(global row, flat slot) of every real slot of a JAX v1 plan, sorted
    as the schedule orders them."""
    e = np.asarray(jp.edges).reshape(jp.nc, 3, jp.eb)
    rb_ids = np.asarray(jp.rb_ids)
    val = e[:, 2].view(np.float32)
    c, s = np.nonzero(val != 0)
    row = rb_ids[c].astype(np.int64) * jp.rb + e[c, 0, s]
    return sorted(zip(row.tolist(), (c * jp.eb + s).tolist()))


@pytest.mark.parametrize("case", sorted(V1_SCHEDULE_CASES))
def test_v1_schedule_matches_a_recount(case):
    """Slot order and row pointers from the JAX plan's planes (pads never
    listed); work items cover each row's slots once, at most SEG_SLOTS
    each, in order."""
    (row, col, val, r, c), geometry = v1_case(case)
    p = build_plan_v1_arrays(row, col, val, r, c, *geometry, device="cpu")
    jp = jax_build_v1(row, col, val, r, c, *geometry)
    s = p.sched
    want = v1_recount(jp)
    np.testing.assert_array_equal(s.order.numpy(), [q for _, q in want])
    cnt = np.bincount([rw for rw, _ in want], minlength=r)
    np.testing.assert_array_equal(s.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(cnt)]))
    seg_ptr, seg_row = s.seg_ptr.numpy(), s.seg_row.numpy()
    want_seg = [(rw, a, min(a + tiling.SEG_SLOTS, s.row_ptr[rw + 1].item()))
                for rw in range(r)
                for a in range(int(s.row_ptr[rw]), int(s.row_ptr[rw + 1]),
                               tiling.SEG_SLOTS)]
    assert list(zip(seg_row.tolist(), seg_ptr[:-1].tolist(),
                    seg_ptr[1:].tolist())) == want_seg
    if case == "hub":
        assert cnt.max() > tiling.SEG_SLOTS and (cnt == 0).any()
        assert p.chunk_starts.diff().min() >= 1  # the empty row block's pad


def walk_v1(plan, x):
    """K10's walk in plain PyTorch: each work item sums its slots' values
    times the x rows of their global columns into its row."""
    s = plan.sched
    e = plan.edges.reshape(plan.nc, 3, plan.eb)
    out = x.new_zeros(plan.num_rows, x.shape[1])
    for j, rw in enumerate(s.seg_row.tolist()):
        q = s.order[s.seg_ptr[j]:s.seg_ptr[j + 1]].long()
        ch, sl = q // plan.eb, q % plan.eb
        col = plan.ct_ids[ch].long() * plan.ct + e[ch, 1, sl].long()
        val = e[ch, 2, sl].view(torch.float32)
        out[rw] += (val[:, None] * x[col]).sum(0)
    return out


@pytest.mark.parametrize("case", sorted(V1_SCHEDULE_CASES))
def test_v1_schedule_walk_matches_plain_version(case):
    (row, col, val, r, c), geometry = v1_case(case)
    p = build_plan_v1_arrays(row, col, val, r, c, *geometry, device="cpu")
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(c, 24)).astype(np.float32))
    scale_close(walk_v1(p, x), spmm_rowblock_plain(p, x), 1e-5)


def test_v1_schedule_walk_matches_pallas():
    """The hub case, a row split over work items and an empty row block,
    against the interpret-mode Pallas ``spmm_tiled`` in fp32."""
    (row, col, val, r, c), geometry = v1_case("hub")
    p = build_plan_v1_arrays(row, col, val, r, c, *geometry, device="cpu")
    jp = jax_build_v1(row, col, val, r, c, *geometry)
    x = np.random.default_rng(15).normal(size=(c, 8)).astype(np.float32)
    want = jax_spmm_tiled(jp, jnp.asarray(x), compute_dtype=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    scale_close(walk_v1(p, torch.from_numpy(x)), want, 1e-5)


# ---------------------------------------------------------------------------
# K2's schedule over the v5 plan and K8's over the v2 plan: a recount (K2's
# from the plan's blk_rowptr, K8's from the JAX plan's own arrays, pads
# included), a plain walk over each against the kernels' plain versions
# with forced small pieces and items, and the walks against JAX
# ---------------------------------------------------------------------------

V5_SCHEDULE_CASES = {"coo-16": ("coo", 16), "hub-12": ("hub", 12)}


def v5_case(case):
    graph, thr = V5_SCHEDULE_CASES[case]
    row, col, val, r, c = hub_coo() if graph == "hub" else coo()
    return (row, col, val, r, c), thr


def v5_plan(case, **kw):
    (row, col, val, r, c), thr = v5_case(case)
    return build_hybrid_plan(row, col, val, r, c, "cpu",
                             dense_threshold=thr, **kw)


@pytest.mark.parametrize("case", sorted(V5_SCHEDULE_CASES))
def test_v5_schedule_matches_a_recount(case):
    """Every block a member, in plan order, with its block column; pieces
    cover each block-row's blocks once, at most PIECE_BLOCKS each,
    longest first, split where the block-row holds more; zeroed
    block-rows: those without blocks and the split ones."""
    p = v5_plan(case)
    s = p.sched
    rowptr, blk_col = p.blk_rowptr.numpy(), p.blk_col.numpy()
    np.testing.assert_array_equal(
        s.members.numpy(), np.stack([np.arange(p.nb), blk_col], 1))
    cnt = np.diff(rowptr)
    pieces = s.pieces.numpy()
    covered = np.concatenate([np.arange(a, b) for a, b, _, _ in pieces])
    np.testing.assert_array_equal(np.sort(covered), np.arange(p.nb))
    sizes = pieces[:, 1] - pieces[:, 0]
    assert sizes.min() >= 1 and sizes.max() <= tiling_v5.PIECE_BLOCKS
    assert (np.diff(sizes) <= 0).all()
    for a, b, br, split in pieces:
        assert rowptr[br] <= a < b <= rowptr[br + 1]
        assert split == (cnt[br] > tiling_v5.PIECE_BLOCKS)
    assert pieces.shape[0] == (-(-cnt // tiling_v5.PIECE_BLOCKS)).sum()
    np.testing.assert_array_equal(
        s.zero_rbs.numpy(),
        np.flatnonzero((cnt == 0) | (cnt > tiling_v5.PIECE_BLOCKS)))
    if case == "hub-12":
        assert pieces[:, 3].any() and (cnt == 0).any()


@pytest.mark.parametrize("piece_blocks", [0, 65])
def test_v5_schedule_rejects_pieces_k2_cannot_hold(piece_blocks):
    """K2 keeps a piece's block list in shared memory: 1 to 64."""
    p = v5_plan("hub-12")
    with pytest.raises(ValueError, match="piece_blocks"):
        tiling_v5.derive_block_schedule(p, piece_blocks=piece_blocks)
    s = tiling_v5.derive_block_schedule(p, piece_blocks=64)
    assert int((s.pieces[:, 1] - s.pieces[:, 0]).max()) <= 64


def walk_v5(plan, x):
    """K2's walk in plain PyTorch: each piece sums its blocks (bf16) times
    the bf16-rounded x tiles of their block columns, in fp32, and adds the
    sum into its block-row."""
    s, k = plan.sched, x.shape[1]
    xb = x.new_zeros(-(-plan.num_cols // 128) * 128, k)
    xb[: plan.num_cols] = x.to(torch.bfloat16).float()
    out = x.new_zeros(plan.n_br * 128, k)
    for a, b, br, _ in s.pieces.tolist():
        acc = x.new_zeros(128, k)
        for j, bc in s.members[a:b].tolist():
            acc += plan.blocks[j].float() @ xb[bc * 128:(bc + 1) * 128]
        out[br * 128:(br + 1) * 128] += acc
    return out[: plan.num_rows]


@pytest.mark.parametrize("piece_blocks", [4, tiling_v5.PIECE_BLOCKS])
@pytest.mark.parametrize("case", sorted(V5_SCHEDULE_CASES))
def test_v5_schedule_walk_matches_plain_version(case, piece_blocks):
    p = v5_plan(case)
    p = dataclasses.replace(p, sched=tiling_v5.derive_block_schedule(
        p, piece_blocks=piece_blocks))
    if piece_blocks == 4:
        assert int(p.sched.pieces[:, 3].sum()) > 0
    x = torch.from_numpy(np.random.default_rng(16).normal(
        size=(p.num_cols, 24)).astype(np.float32))
    scale_close(walk_v5(p, x), spmm_bsr_plain(p, x), 1e-5)


def test_v5_schedule_walk_matches_pallas():
    """The hub case, whose block-row 0 is split and block-row 2 empty: the
    walk plus the residual half against JAX's interpret-mode
    ``spmm_hybrid_v5`` within the bf16 contract of tests/test_v5.py (JAX
    rounds its residual products to bf16; the port does not)."""
    (row, col, val, r, c), thr = v5_case("hub-12")
    p = v5_plan("hub-12")
    assert int(p.sched.pieces[:, 3].sum()) > 0
    assert int(p.sched.zero_rbs.numel()) > 0
    jp = jax_build_v5(row, col, val, r, c, rb=128, k=8,
                      dense_threshold=thr, S=2, g=4)
    assert jp.dense_edges == p.dense_edges
    x = np.random.default_rng(17).normal(size=(c, 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = walk_v5(p, xt)
    spmm_stream_plain(p, xt, got)
    want = np.asarray(jax_spmm_hybrid_v5(jp, jnp.asarray(x)))
    scale_close(got, want, 2e-2)


V2_SCHEDULE_CASES = {"256-512-512": ("coo", (256, 512, 512)),
                     "128-128-128": ("coo", (128, 128, 128)),
                     "hub": ("hub", (128, 256, 256))}


def v2_case(case):
    graph, geometry = V2_SCHEDULE_CASES[case]
    return (hub_coo() if graph == "hub" else coo()), geometry


def v2_plan(case):
    (row, col, val, r, c), (rb, ct, eb) = v2_case(case)
    return build_plan_v2_arrays(row, col, val, r, c, rb=rb, ct=ct, eb=eb,
                                device="cpu")


def v2_recount(jp):
    """(global row, flat slot, global col) of every real slot of a JAX v2
    plan, sorted as the schedule orders them, and each chunk's first row
    and column, from the plan's planes, ``rb_locals`` and
    ``cell_starts``."""
    e = np.asarray(jp.edges)[:jp.nc].reshape(jp.nc, 3, jp.eb)
    cs, rbl = np.asarray(jp.cell_starts), np.asarray(jp.rb_locals)
    nct = -(-jp.num_cols // jp.ct)
    cell = np.searchsorted(cs, np.arange(jp.nc), side="right") - 1
    row0 = ((cell // nct) * jp.nrb_s + rbl[:jp.nc]).astype(np.int64) * jp.rb
    col0 = (cell % nct).astype(np.int64) * jp.ct
    c, s = np.nonzero(e[:, 1].view(np.float32) != 0)
    slots = sorted(zip((row0[c] + e[c, 2, s]).tolist(),
                       (c * jp.eb + s).tolist(),
                       (col0[c] + e[c, 0, s]).tolist()))
    return slots, row0, col0


@pytest.mark.parametrize("case", sorted(V2_SCHEDULE_CASES))
def test_v2_schedule_matches_a_recount(case):
    """Slot order, row pointers and the chunks' offsets from the JAX
    plan's arrays, which equal the port's pads included; work items cover
    each row's slots once, at most ITEM_SLOTS each, in order; zeroed rows:
    those without slots and the split ones."""
    (row, col, val, r, c), (rb, ct, eb) = v2_case(case)
    p = v2_plan(case)
    jp = jax_build_v2(row, col, val, r, c, rb=rb, ct=ct, eb=eb)
    equal_arrays(p.edges, jp.edges, "edges")
    s = p.sched
    slots, row0, col0 = v2_recount(jp)
    np.testing.assert_array_equal(s.order.numpy(), [q for _, q, _ in slots])
    np.testing.assert_array_equal(s.chunk_row.numpy(), row0)
    np.testing.assert_array_equal(s.chunk_col.numpy(), col0)
    # a slot decodes through its chunk's column offset alone
    e = p.edges[:p.nc].reshape(p.nc, 3, p.eb)
    q = s.order.long()
    ch = q // p.eb
    np.testing.assert_array_equal(
        (s.chunk_col.long()[ch] + e[ch, 0, q % p.eb]).numpy(),
        [cl for _, _, cl in slots])
    cnt = np.bincount([rw for rw, _, _ in slots], minlength=r)
    np.testing.assert_array_equal(s.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(cnt)]))
    seg_ptr, seg_row = s.seg_ptr.numpy(), s.seg_row.numpy()
    want_seg = [(rw, a, min(a + ITEM_SLOTS, int(s.row_ptr[rw + 1])))
                for rw in range(r)
                for a in range(int(s.row_ptr[rw]), int(s.row_ptr[rw + 1]),
                               ITEM_SLOTS)]
    assert list(zip(seg_row.tolist(), seg_ptr[:-1].tolist(),
                    seg_ptr[1:].tolist())) == want_seg
    np.testing.assert_array_equal(
        s.zero_rows.numpy(), np.flatnonzero((cnt == 0) | (cnt > ITEM_SLOTS)))
    if case == "hub":
        assert cnt.max() > ITEM_SLOTS and (cnt == 0).any()


def test_v2_schedule_rejects_what_k8_cannot_walk():
    """Work items of at least one slot; no schedule of a with-eids plan
    (K7's, which carries none)."""
    p = v2_plan("hub")
    with pytest.raises(ValueError, match="seg_slots"):
        tiling_v2.derive_v2_schedule(p, seg_slots=0)
    (row, col, val, r, c), (rb, ct, eb) = v2_case("hub")
    pe = build_plan_v2_arrays(row, col, val, r, c, rb=rb, ct=ct, eb=eb,
                              with_eids=True, device="cpu")
    assert pe.sched is None
    with pytest.raises(ValueError, match="edge ids"):
        tiling_v2.derive_v2_schedule(pe)


def walk_v2(plan, x):
    """K8's walk in plain PyTorch: each work item sums its slots' values
    times the x rows of their global columns (the chunk's column offset
    plus plane 0) into its row."""
    s = plan.sched
    e = plan.edges[:plan.nc].reshape(plan.nc, 3, plan.eb)
    out = x.new_zeros(plan.num_rows, x.shape[1])
    for j, rw in enumerate(s.seg_row.tolist()):
        q = s.order[s.seg_ptr[j]:s.seg_ptr[j + 1]].long()
        ch, sl = q // plan.eb, q % plan.eb
        assert bool((s.chunk_row.long()[ch] + e[ch, 2, sl] == rw).all())
        col = s.chunk_col.long()[ch] + e[ch, 0, sl].long()
        val = e[ch, 1, sl].view(torch.float32)
        out[rw] += (val[:, None] * x[col]).sum(0)
    return out


@pytest.mark.parametrize("seg_slots", [32, ITEM_SLOTS, 256])
@pytest.mark.parametrize("case", sorted(V2_SCHEDULE_CASES))
def test_v2_schedule_walk_matches_plain_version(case, seg_slots):
    p = v2_plan(case)
    p = dataclasses.replace(p, sched=tiling_v2.derive_v2_schedule(
        p, seg_slots=seg_slots))
    if seg_slots == 32:
        assert int((p.sched.row_ptr.diff() > 32).sum()) > 0
    x = torch.from_numpy(np.random.default_rng(18).normal(
        size=(p.num_cols, 24)).astype(np.float32))
    scale_close(walk_v2(p, x), spmm_v2_plain(p, x), 1e-5)


def test_v2_schedule_walk_matches_pallas():
    """The hub case, a row split over work items and empty rows, against
    the interpret-mode Pallas ``spmm_tiled_v2`` in fp32."""
    (row, col, val, r, c), (rb, ct, eb) = v2_case("hub")
    p = v2_plan("hub")
    jp = jax_build_v2(row, col, val, r, c, rb=rb, ct=ct, eb=eb)
    x = np.random.default_rng(19).normal(size=(c, 8)).astype(np.float32)
    want = spmm_tiled_v2(jp, jnp.asarray(x), compute_dtype=jnp.float32)
    scale_close(walk_v2(p, torch.from_numpy(x)), want, 1e-5)


@pytest.mark.parametrize("version", [2, 3, 5])
def test_plans_carry_their_kernels_schedules(version):
    """Both directions of ``build_tiling(version=2|5)`` and the version-3
    residuals carry K8's or K2's schedule; the sharded route's plans too
    (version 2: K8's; version 5: K2's where a shard plan has blocks); its
    with-eids max/min plans carry K7's instead, and ``fwd_mm`` K3's."""
    row, col, val, r, c = coo(20, num_rows=640, num_cols=640)
    g = pt.from_edge_index(np.stack([col, row]), num_nodes=r,
                           num_src_nodes=c, edge_value=val,
                           edge_multiple=128, device="cpu")
    kw = {2: dict(rb=128, ct=128, eb=128),
          3: dict(rb=128, ct=128, eb=128, dense_threshold=250, g=4),
          5: dict(dense_threshold=250)}[version]
    tiled = build_tiling(g, version=version, k=16, **kw)
    assert tiled.fwd_mm.sched is not None
    for plan in (tiled.fwd, tiled.bwd):
        if version == 3:
            assert plan.bsr.sched is not None
            plan = plan.residual
        if version == 5:
            assert plan.nb > 0 and plan.sparse_edges > 0
        assert plan.sched is not None
    if version == 3:
        return
    sg = partition_rows(row, col, val, r, 4, device="cpu",
                        tiling=dict(version=version))
    plans = [p for i in sg.held for p in sg.shard(i).plans]
    for plan in plans:
        assert (plan.sched is None) == (version == 5 and plan.nb == 0)
    assert all(p.sched is not None for p in plans[:1])  # shard 0, local
    for plan in (p for i in sg.held for p in sg.shard(i).plans_mm):
        assert plan.with_eids and plan.sched is None
        assert plan.mm_sched is not None


# ---------------------------------------------------------------------------
# The max/min walk that K3 and K7 share (sparse/minmax_sched.py): a recount
# of each schedule and a plain walk over it, with the kernels' tie rule,
# against the plain versions (bit for bit) and the interpret-mode Pallas
# kernels
# ---------------------------------------------------------------------------

MM_ROWS, MM_COLS = 700, 2000
# item_edges of derive_walk: the default (256: the hub row in two items),
# and items of 1 (every row of two edges or more split), 5, 16 and 100
MM_SCHEDULES = {"default": {},
                "items-1": dict(item_edges=1),
                "items-5": dict(item_edges=5),
                "items-16": dict(item_edges=16),
                "items-100": dict(item_edges=100)}


def minmax_coo(seed=30):
    """CSR-ordered edges with what the walk must meet: a dense corner (rows
    and columns < 256, ~23 edges a row, so rows read the same x rows),
    sparse uniform rows, a hub row of 500 edges (two items of 256), the
    last 40 rows empty, values in {-1, 0, 1} (value-0 edges, ±0.0
    products) and duplicate edges."""
    rng = np.random.default_rng(seed)
    nc, nu, nh = 6000, 1500, 500
    row = np.concatenate([rng.integers(0, 256, nc),
                          rng.integers(0, MM_ROWS - 40, nu),
                          np.full(nh, 600)])
    col = np.concatenate([rng.integers(0, 256, nc),
                          rng.integers(0, MM_COLS, nu),
                          rng.integers(0, MM_COLS, nh)])
    row = np.concatenate([row, row[:300]])
    col = np.concatenate([col, col[:300]])
    o = np.lexsort((col, row))
    row, col = row[o], col[o]
    val = rng.choice(np.float32([-1.0, 0.0, 1.0]), row.shape[0],
                     p=[0.4, 0.2, 0.4])
    return row, col, val


def minmax_x(k, seed=31):
    """Rounded features: products tie, and round() gives -0.0 too."""
    return torch.from_numpy(np.round(np.random.default_rng(seed).normal(
        size=(MM_COLS, k))).astype(np.float32))


class K3Case:
    """K3's plan of ``minmax_coo`` and its edge decoder (ref = CSR
    position = id)."""

    k7 = False

    def __init__(self, **kw):
        from isplib_tpu_torch.sparse.tiling_v4mm import (
            build_minmax_plan, derive_minmax_schedule)
        row, col, val = minmax_coo()
        self.g = pt.from_edge_index(np.stack([col, row]), num_nodes=MM_ROWS,
                                    num_src_nodes=MM_COLS, edge_value=val,
                                    edge_multiple=128, device="cpu")
        self.plan = build_minmax_plan(self.g.rowptr.numpy(), MM_ROWS,
                                      MM_COLS, "cpu", schedule=True)
        if kw:
            self.plan = dataclasses.replace(
                self.plan, sched=derive_minmax_schedule(self.plan, **kw))
        self.sched = self.plan.sched
        self.sentinel = self.g.nnz_padded - 1
        self.rows = self.plan.edge_rows()
        self.refs = torch.arange(self.g.nnz)

    def decode(self, ref):
        """(row, col, val, id) of refs."""
        ref = ref.long()
        return (self.rows[ref], self.g.col.long()[ref], self.g.value[ref],
                ref)

    def plain(self, x, reduce):
        from isplib_tpu_torch.kernels import spmm_minmax_v4 as k3
        return k3.spmm_minmax_v4(self.plan, self.g.col, self.g.value, x,
                                 reduce, self.sentinel)


class K7Case:
    """K7's with-eids plan of ``minmax_coo`` and its edge decoder (ref =
    flat slot index); ids a permutation, out of slot order, unless
    ``permuted`` is False (each edge's input position)."""

    k7 = True

    def __init__(self, permuted=True, **kw):
        row, col, val = minmax_coo()
        self.ids = (np.random.default_rng(32).permutation(row.shape[0])
                    if permuted else None)
        self.coo = (row, col, val)
        self.plan = build_plan_v2_arrays(
            row, col, val, MM_ROWS, MM_COLS, rb=128, ct=128, eb=128,
            with_eids=True, orig_ids=self.ids, device="cpu")
        if kw:
            self.plan = dataclasses.replace(
                self.plan, mm_sched=tiling_v2.derive_v2_minmax_schedule(
                    self.plan, **kw))
        self.sched = self.plan.mm_sched
        self.sentinel = row.shape[0] + 7
        p = self.plan
        self.e = p.edges[:p.nc].reshape(p.nc, 4, p.eb)
        self.row0 = p.chunk_offsets()[0]
        self.refs = torch.nonzero(self.e[:, 3].reshape(-1) >= 0).flatten()

    def decode(self, ref):
        ref = ref.long()
        ch, sl = ref // self.plan.eb, ref % self.plan.eb
        return (self.row0[ch] + self.e[ch, 2, sl],
                self.sched.chunk_col.long()[ch] + self.e[ch, 0, sl],
                self.e[ch, 1, sl].view(torch.float32),
                self.e[ch, 3, sl].long())

    def plain(self, x, reduce):
        from isplib_tpu_torch.kernels import spmm_minmax as k7
        return k7.spmm_minmax_v2(self.plan, x, reduce, self.sentinel)


MM_CASES = {"K3": K3Case, "K7": K7Case}


def minmax_recount(case):
    """The schedule recounted in numpy from the edges the decoder gives:
    each item (row, refs: the row's edges by id, cut every item_edges),
    the rows to split and the empty rows."""
    s = case.sched
    row, _, _, ids = (t.numpy() for t in case.decode(case.refs))
    refs = case.refs.numpy()
    items, split = [], []
    for r in np.unique(row):
        m = row == r
        rr = refs[m][np.argsort(ids[m], kind="stable")]  # by id
        cut = [rr[a:a + s.item_edges]
               for a in range(0, rr.shape[0], s.item_edges)]
        items += [(int(r), list(c)) for c in cut]
        if len(cut) > 1:
            split.append(int(r))
    empty = np.setdiff1d(np.arange(s.row_slot.shape[0]), row)
    return items, split, empty


@pytest.mark.parametrize("sched", sorted(MM_SCHEDULES))
@pytest.mark.parametrize("kernel", sorted(MM_CASES))
def test_minmax_schedule_matches_a_recount(kernel, sched):
    """Items (a row's edges by id), split rows and their scratch rows,
    empty rows; every real edge once."""
    case = MM_CASES[kernel](**MM_SCHEDULES[sched])
    s = case.sched
    items, split, empty = minmax_recount(case)
    got_items = []
    for lo, hi, r in s.items.tolist():
        refs = (torch.arange(lo, hi) if s.order is None
                else s.order[lo:hi].long())
        got_items.append((r, refs.tolist()))
    assert got_items == items
    assert (s.order is None) == (kernel == "K3")
    assert sorted(sum((t for _, t in got_items), [])) == case.refs.tolist()
    assert s.split_rows.tolist() == split
    want_slot = np.full(s.row_slot.shape[0], -1)
    want_slot[split] = np.arange(len(split))
    np.testing.assert_array_equal(s.row_slot.numpy(), want_slot)
    np.testing.assert_array_equal(s.zero_rows.numpy(), empty)
    assert 600 in split  # the hub's items
    n_hub = sum(r == 600 for r, _ in items)
    assert n_hub == -(-len(case.refs[case.decode(case.refs)[0] == 600])
                      // s.item_edges)
    if sched == "default":
        assert split == [600]
    if sched == "items-1":
        assert min(split) == 0 and len(split) > MM_ROWS // 2


def ranges(lo, hi):
    """The concatenated ranges [lo[i], hi[i]) and each one's index."""
    n = hi - lo
    run = torch.repeat_interleave(torch.arange(n.shape[0]), n)
    return lo[run] + torch.arange(run.shape[0]) - (torch.cumsum(n, 0)
                                                   - n)[run], run


def walk_minmax(case, x, reduce):
    """The kernels' walk in plain PyTorch, item by item: each item picks,
    per feature, its winner under the tie rule (the larger product, then
    the lower id; -0.0 == +0.0); a row of one item stores it (K3: sign·w,
    the winner's own product; K7: sign·(w + 0.0)); a split row, whose
    items meet through the 64-bit key's order (zeros as +0.0) in the
    scratch, is decoded from the key (K3: the winner's product recomputed
    from its id; K7: sign·w)."""
    s, k = case.sched, x.shape[1]
    sgn = -1.0 if reduce == "min" else 1.0
    num_rows = s.row_slot.shape[0]
    feats = torch.arange(k)
    none = 2**62

    it = s.items.long()
    pos, run = ranges(it[:, 0], it[:, 1])
    refs = pos if s.order is None else s.order.long()[pos]
    row = it[run, 2]
    rows, c, v, e = case.decode(refs)
    assert torch.equal(rows, row)
    assert torch.equal(torch.sort(refs).values, torch.sort(case.refs).values)

    # each item's winner and its own product
    w = (sgn * v)[:, None] * x[c]
    idx = run[:, None].expand_as(w)
    best = w.new_full((s.nseg, k), -float("inf")).scatter_reduce(
        0, idx, w, "amax")
    cand = torch.where(w == best[run], e[:, None], none)
    bid = torch.full_like(best, none, dtype=torch.int64).scatter_reduce(
        0, idx, cand, "amin")
    at = torch.full((int(e.max()) + 1,), -1, dtype=torch.int64)
    at[e] = torch.arange(e.shape[0])
    bw = w[at[bid], feats]
    item_row = it[:, 2]

    out = torch.full((num_rows, k), float("nan"))
    arg = torch.full((num_rows, k), -2, dtype=torch.int32)
    out[s.zero_rows.long()] = 0.0
    arg[s.zero_rows.long()] = case.sentinel

    slot = s.row_slot.long()[item_row]
    kw = bw + 0.0  # the key's zero is +0.0
    alone = slot < 0
    out[item_row[alone]] = sgn * kw[alone] if case.k7 else sgn * bw[alone]
    arg[item_row[alone]] = bid[alone].int()
    split = ~alone
    sidx = slot[split][:, None].expand(-1, k)
    kbest = kw.new_full((s.nsplit, k), -float("inf")).scatter_reduce(
        0, sidx, kw[split], "amax")
    kid = torch.full_like(kbest, none, dtype=torch.int64).scatter_reduce(
        0, sidx, torch.where(kw[split] == kbest[slot[split]], bid[split],
                             none), "amin")
    r = s.split_rows.long()
    arg[r] = kid.int()
    if case.k7:
        out[r] = sgn * kbest
    else:
        _, kc, kv, _ = case.decode(kid.reshape(-1))
        out[r] = (kv * x[kc, feats.repeat(kid.shape[0])]).view(-1, k)
    assert not bool(out.isnan().any()) and not bool((arg == -2).any())
    return out, arg


@pytest.mark.parametrize("k", [8, 41])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("sched", sorted(MM_SCHEDULES))
@pytest.mark.parametrize("kernel", sorted(MM_CASES))
def test_minmax_schedule_walk_matches_plain_version(kernel, sched, reduce,
                                                    k):
    """Bit for bit, args equal: values of -0.0 and +0.0 included."""
    case = MM_CASES[kernel](**MM_SCHEDULES[sched])
    x = minmax_x(k)
    out, arg = walk_minmax(case, x, reduce)
    want, want_arg = case.plain(x, reduce)
    assert torch.equal(arg, want_arg)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert bool(((out == 0) & (arg != case.sentinel)).any())  # zero wins


@pytest.mark.parametrize("kernel, reduce", [("K3", "max"), ("K7", "min")])
def test_minmax_schedule_walk_matches_pallas(kernel, reduce):
    """The walk over items of 16 edges (split rows all over the graph)
    against the interpret-mode Pallas kernel: K3's ``spmm_minmax_v4`` on
    its stripes, K7's ``spmm_minmax_tiled`` on the JAX with-eids plan;
    values as numbers (1e-6, as tests/test_torch_minmax.py holds K3), args
    exactly.  K7's ids are the input positions here: the Pallas kernel
    breaks a tie by plan order, which is id order only then."""
    from isplib_tpu.kernels.spmm_minmax import spmm_minmax_tiled
    from isplib_tpu.kernels.spmm_minmax_v4 import spmm_minmax_v4 as jax_k3
    from isplib_tpu.sparse.tiling_v4mm import build_minmax_stripes
    kw = MM_SCHEDULES["items-16"]
    case = (K3Case(**kw) if kernel == "K3"
            else K7Case(permuted=False, **kw))
    assert case.sched.nsplit > 100
    x = minmax_x(8)
    out, arg = walk_minmax(case, x, reduce)
    if kernel == "K3":
        g, n = case.g, case.g.nnz
        jp = build_minmax_stripes(g.row[:n].numpy(), g.col[:n].numpy(),
                                  g.value[:n].numpy(), MM_ROWS, MM_COLS,
                                  k=8)
        want, want_arg = jax_k3(jp, jnp.asarray(x.numpy()), reduce,
                                case.sentinel)
    else:
        row, col, val = case.coo
        jp = jax_build_v2(row, col, val, MM_ROWS, MM_COLS, rb=128, ct=128,
                          eb=128, k=8, with_eids=True, orig_ids=case.ids)
        want, want_arg = spmm_minmax_tiled(jp, jnp.asarray(x.numpy()),
                                           reduce, case.sentinel)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))


def test_minmax_schedule_rejects_empty_items_and_pieces():
    """An item of no edges, and K7's schedule of a plan without edge ids
    (K8's), raise."""
    case = K3Case()
    from isplib_tpu_torch.sparse.tiling_v4mm import derive_minmax_schedule
    with pytest.raises(ValueError, match="at least one"):
        derive_minmax_schedule(case.plan, item_edges=0)
    with pytest.raises(ValueError, match="edge ids"):
        tiling_v2.derive_v2_minmax_schedule(v2_plan("hub"))
