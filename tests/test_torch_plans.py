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
from isplib_tpu.kernels.spmm_pallas import spmm_tiled as jax_spmm_tiled
from isplib_tpu.kernels.spmm_pallas_v2 import spmm_tiled_v2
from isplib_tpu.sparse.graph import _build_arrays as jax_build_arrays
from isplib_tpu.sparse.tiling import _build_plan_arrays as jax_build_v1
from isplib_tpu.sparse.tiling import \
    build_tiling_from_numpy as jax_build_tiling
from isplib_tpu.sparse.tiling_v3 import build_plan_v3_arrays as jax_build_v3
from isplib_tpu_torch.kernels import spmm_hybrid
from isplib_tpu_torch.kernels.spmm_bsr_v3 import spmm_bsr_v3_plain
from isplib_tpu_torch.kernels.spmm_rowblock import spmm_rowblock_plain
from isplib_tpu_torch.sparse import tiling_v3
from isplib_tpu_torch.sparse.tiling import (TiledGraph, TiledPlan,
                                            build_plan_v1_arrays,
                                            build_tiling)
from isplib_tpu_torch.sparse.tiling_v2 import TiledPlanV2
from isplib_tpu_torch.sparse.tiling_v3 import (HybridPlanV3,
                                               build_plan_v3_arrays)
from isplib_tpu_torch.sparse.tiling_v5 import HybridPlan


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
