"""The port's FusedMM pipeline (``fused_mm``, ``fused_mm_edges``, K5 and K6
through their plain versions on a CPU TiledGraph, the plain formulation on
a CSRGraph) against the JAX package's XLA path: outputs within 1e-5 of the
output's scale and gradients within 1e-4 of theirs (fp32 on both sides,
only the sum order differs), and one tiny case against the JAX Pallas
kernel in interpret mode at that test's own 3e-2 (its scatter is bf16)."""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import isplib_tpu
import isplib_tpu_torch as pt
from isplib_tpu.ops import semiring as jsr
from isplib_tpu.ops.fused import fused_mm as jax_fused_mm
from isplib_tpu.ops.fused import fused_mm_edges as jax_fused_mm_edges
from isplib_tpu_torch.kernels import build, fused, fused_bwd, spmm_minmax_v4
from isplib_tpu_torch.ops import reference
from isplib_tpu_torch.ops.semiring import (FusedOp, Reduce, ReduceOp,
                                           ScalarOp, ScaleOp, VectorOp)
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.sparse.tiling_v5 import SEG_EDGES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, E = 300, 280, 4000

JAX_SOP = {None: None, ScalarOp.SIGMOID: jax.nn.sigmoid,
           ScalarOp.TDIST: lambda t: 1.0 / (1.0 + t)}

SIGMOID_EMBED = FusedOp(VectorOp.MUL, ReduceOp.DOT, ScalarOp.SIGMOID,
                        ScaleOp.MUL, Reduce.SUM)
TDIST_FORCE = FusedOp(VectorOp.SUB, ReduceOp.NORM2, ScalarOp.TDIST,
                      ScaleOp.MUL, Reduce.SUM)
PIPELINES = {"sigmoid-embed": SIGMOID_EMBED, "tdist-force": TDIST_FORCE,
             "copy_rhs-mean": FusedOp.spmm("mean"),
             "sddmm_dot": FusedOp.sddmm_dot()}


def jax_op(op: FusedOp):
    return jsr.FusedOp(vop=jsr.VectorOp(op.vop.value),
                       rop=jsr.ReduceOp(op.rop.value), sop=JAX_SOP[op.sop],
                       vsc=jsr.ScaleOp(op.vsc.value),
                       aop=jsr.Reduce(op.aop.value))


def coo(seed, num_rows=N, num_cols=M, nnz=E, zeros=False):
    """Rows num_rows-30.. empty; a third of the edges in two hub rows and
    a fifth in two hub columns, of several segments each (split rows of A
    and of Aᵀ); normal values (every 7th 0 with ``zeros``)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, num_rows - 30, nnz)
    src = rng.integers(0, num_cols, nnz)
    hub = rng.random(nnz) < 0.35
    dst[hub] = rng.integers(0, 2, hub.sum())
    hub_col = rng.random(nnz) < 0.2
    src[hub_col] = rng.integers(0, 2, hub_col.sum())
    val = rng.normal(size=nnz).astype(np.float32)
    if zeros:
        val[::7] = 0.0
    return np.stack([src, dst]), val


def graphs(seed, **kw):
    ei, val = coo(seed, **kw)
    num_rows, num_cols = kw.get("num_rows", N), kw.get("num_cols", M)
    args = dict(num_nodes=num_rows, num_src_nodes=num_cols, edge_value=val,
                edge_multiple=128)
    tg = pt.from_edge_index(ei, device="cpu", **args)
    return tg, build_tiling(tg), isplib_tpu.from_edge_index(ei, **args)


def features(seed, k, num_rows=N, num_cols=M, scale=1.0):
    rng = np.random.default_rng(seed + 100)
    return ((scale * rng.normal(size=(num_rows, k))).astype(np.float32),
            (scale * rng.normal(size=(num_cols, k))).astype(np.float32))


def port_run(graph, op, x, y, w, **kw):
    """fused_mm's output and the gradients of <out, w> in x and y (a side
    the pipeline does not read gets zeros, as in JAX)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = pt.fused_mm(graph, xt, yt, op, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [np.zeros_like(a) if t.grad is None else t.grad.numpy()
             for a, t in ((x, xt), (y, yt))]
    return out.detach().numpy(), grads


def jax_run(jg, op, x, y, w):
    jop = jax_op(op)
    want = jax_fused_mm(jg, jnp.asarray(x), jnp.asarray(y), jop,
                        backend="xla")
    grads = jax.grad(lambda a, b: jnp.sum(jax_fused_mm(
        jg, a, b, jop, backend="xla") * w), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    return np.asarray(want), [np.asarray(g) for g in grads]


def assert_scaled(got, want, tol):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def hub():
    return graphs(3)


@pytest.mark.parametrize("k", [8, 16, 41])
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_fused_mm_matches_jax_xla(hub, name, tiled, k):
    tg, tt, jg = hub
    op = PIPELINES[name]
    x, y = features(k, k)
    w = np.random.default_rng(k).normal(size=(N, k)).astype(np.float32)
    got, (gx, gy) = port_run(tt if tiled else tg, op, x, y, w)
    want, (wx, wy) = jax_run(jg, op, x, y, w)
    assert_scaled(got, want, 1e-5)
    assert_scaled(gx, wx, 1e-4)
    assert_scaled(gy, wy, 1e-4)


def test_tiled_sum_route_runs_k5_and_k6(hub, monkeypatch):
    """A CPU TiledGraph runs the kernels' plain versions: K5 forward, K6
    pass A (CSR work list) and pass B (CSC work list); a CSRGraph runs
    neither."""
    tg, tt, _ = hub
    assert tt.fwd_mm.nsplit > 0 and tt.bwd_mm.nsplit > 0
    calls = []
    f, b = fused.fused_plain, fused_bwd.fused_bwd_plain
    monkeypatch.setattr(fused, "fused_plain",
                        lambda *a: calls.append(("k5", a[0])) or f(*a))
    monkeypatch.setattr(fused_bwd, "fused_bwd_plain",
                        lambda *a: calls.append(("k6", a[0], a[-1]))
                        or b(*a))
    x, y = features(1, 16)
    w = np.ones((N, 16), np.float32)
    port_run(tt, TDIST_FORCE, x, y, w)
    assert calls == [("k5", tt.fwd_mm), ("k6", tt.fwd_mm, False),
                     ("k6", tt.bwd_mm, True)]
    calls.clear()
    port_run(tt, FusedOp.spmm("sum"), x, y, w)  # COPY_RHS: no pass A
    assert calls == [("k5", tt.fwd_mm), ("k6", tt.bwd_mm, True)]
    calls.clear()
    port_run(tg, TDIST_FORCE, x, y, w)
    assert calls == []


STAGES = [(vop, rop) for vop in VectorOp for rop in ReduceOp]


@pytest.mark.parametrize("vop,rop", STAGES,
                         ids=[f"{v.value}-{r.value}" for v, r in STAGES])
def test_every_stage_matches_jax_xla(hub, vop, rop):
    """Every VOP with every ROP, through the K5/K6 plain versions: the SOP
    and VSC cycle through the catalogue and the three scales."""
    tg, tt, jg = hub
    i = STAGES.index((vop, rop))
    sop = {ReduceOp.NOOP: [None, ScalarOp.SIGMOID, ScalarOp.TDIST][i % 3],
           ReduceOp.DOT: [None, ScalarOp.SIGMOID][i % 2],
           ReduceOp.NORM2: [ScalarOp.TDIST, ScalarOp.SIGMOID][i % 2]}[rop]
    vsc = list(ScaleOp)[i % 3]
    op = FusedOp(vop, rop, sop, vsc, Reduce.SUM)
    x, y = features(i, 12, scale=0.5)
    w = np.random.default_rng(i).normal(size=(N, 12)).astype(np.float32)
    got, (gx, gy) = port_run(tt, op, x, y, w)
    want, (wx, wy) = jax_run(jg, op, x, y, w)
    assert_scaled(got, want, 1e-5)
    assert_scaled(gx, wx, 1e-4)
    assert_scaled(gy, wy, 1e-4)


@pytest.mark.parametrize("vop", [VectorOp.MAX, VectorOp.MIN])
def test_vop_ties_split_the_cotangent(vop):
    """x is y on a square graph with self loops: every self loop ties in
    VOP max/min.  K6's plain version splits the cotangent 0.5 / 0.5 like
    torch autograd of the plain formulation and jax.grad of the XLA path
    (the JAX Pallas kernel gives it to one side)."""
    rng = np.random.default_rng(5)
    src = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N, E), np.arange(N)])
    val = rng.normal(size=src.shape[0]).astype(np.float32)
    args = dict(num_nodes=N, edge_value=val, edge_multiple=128)
    tg = pt.from_edge_index(np.stack([src, dst]), device="cpu", **args)
    jg = isplib_tpu.from_edge_index(np.stack([src, dst]), **args)
    x = np.round(rng.normal(size=(N, 8))).astype(np.float32)
    op = FusedOp(vop, ReduceOp.NORM2, ScalarOp.TDIST, ScaleOp.MUL,
                 Reduce.SUM)
    w = rng.normal(size=(N, 8)).astype(np.float32)
    g = torch.from_numpy(w)
    tiled = build_tiling(tg)
    args = (torch.from_numpy(x), torch.from_numpy(x), g, op)
    grads = [fused_bwd.fused_bwd(tiled.fwd_mm, tg.col, tg.value, *args,
                                 pass_b=False),
             fused_bwd.fused_bwd(tiled.bwd_mm, tg.csc_col, tg.csc_value,
                                 *args, pass_b=True)]
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(x.copy()).requires_grad_(True)
    (pt.fused_mm(tg, xt, yt, op) * g).sum().backward()
    _, (wx, wy) = jax_run(jg, op, x, x, w)
    for got, auto, want in zip(grads, (xt.grad, yt.grad), (wx, wy)):
        assert_scaled(got.numpy(), auto.numpy(), 1e-5)
        assert_scaled(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("aop", ["max", "min"])
@pytest.mark.parametrize("sop", [None, ScalarOp.SIGMOID])
def test_minmax_route_runs_k3(hub, monkeypatch, aop, sop):
    """AOP max/min with the COPY_RHS message on a TiledGraph: the per-edge
    scalars, then K3 (its plain version here) with them as edge values;
    forward and gradients against jax.grad of the XLA path."""
    tg, tt, jg = hub
    calls = []
    plain = spmm_minmax_v4.spmm_minmax_v4_plain
    monkeypatch.setattr(spmm_minmax_v4, "spmm_minmax_v4_plain",
                        lambda *a: calls.append(a[0]) or plain(*a))
    op = FusedOp(VectorOp.COPY_RHS, ReduceOp.NOOP, sop, ScaleOp.MUL,
                 Reduce.of(aop))
    x, y = features(7, 16)
    w = np.random.default_rng(8).normal(size=(N, 16)).astype(np.float32)
    got, (gx, gy) = port_run(tt, op, x, y, w)
    assert calls == [tt.fwd_mm]
    want, (wx, wy) = jax_run(jg, op, x, y, w)
    assert_scaled(got, want, 1e-5)
    assert_scaled(gy, wy, 1e-4)
    assert not gx.any() and not wx.any()
    # the CSRGraph runs the plain formulation: no K3
    got2, _ = port_run(tg, op, x, y, w)
    assert calls == [tt.fwd_mm]
    assert_scaled(got2, want, 1e-5)


def test_zero_valued_edges_count_under_scale_none():
    """Under ScaleOp.NONE a real edge of value 0 contributes, as on the
    JAX package's XLA path (its Pallas path drops such edges)."""
    tg, tt, jg = graphs(9, zeros=True)
    assert int((tg.value[:tg.nnz] == 0).sum()) > 0
    op = FusedOp(VectorOp.MUL, ReduceOp.DOT, ScalarOp.SIGMOID, ScaleOp.NONE,
                 Reduce.SUM)
    x, y = features(9, 16)
    w = np.random.default_rng(9).normal(size=(N, 16)).astype(np.float32)
    got, (gx, gy) = port_run(tt, op, x, y, w)
    want, (wx, wy) = jax_run(jg, op, x, y, w)
    assert_scaled(got, want, 1e-5)
    assert_scaled(gx, wx, 1e-4)
    assert_scaled(gy, wy, 1e-4)


def test_fused_mm_edges_matches_jax(hub):
    tg, tt, jg = hub
    x, y = features(4, 16)
    for op in (SIGMOID_EMBED, TDIST_FORCE, FusedOp.spmm("mean")):
        got = pt.fused_mm_edges(tt, torch.from_numpy(x),
                                torch.from_numpy(y), op)
        want = np.asarray(jax_fused_mm_edges(jg, jnp.asarray(x),
                                             jnp.asarray(y), jax_op(op)))
        assert got.shape == (tg.nnz_padded,)
        assert_scaled(got.numpy(), want, 1e-5)
        assert not got[tg.nnz:].any()


def test_other_callables_take_the_plain_route(hub, monkeypatch):
    """An SOP outside the catalogue runs the plain formulation, decided by
    its type alone: the kernel is never called, and the result equals the
    catalogue member's."""
    tg, tt, jg = hub

    def no_kernel(*a):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(fused, "fused_plain", no_kernel)
    monkeypatch.setattr(fused_bwd, "fused_bwd_plain", no_kernel)
    op = FusedOp(VectorOp.MUL, ReduceOp.DOT, torch.sigmoid, ScaleOp.MUL,
                 Reduce.SUM)
    x, y = features(2, 16)
    w = np.random.default_rng(2).normal(size=(N, 16)).astype(np.float32)
    got, (gx, gy) = port_run(tt, op, x, y, w)
    want, (wx, wy) = jax_run(jg, SIGMOID_EMBED, x, y, w)
    assert_scaled(got, want, 1e-5)
    assert_scaled(gx, wx, 1e-4)
    assert_scaled(gy, wy, 1e-4)
    # so do K > 256, backend="reference", and values that need a gradient
    xw, yw = features(2, 260)
    pt.fused_mm(tt, torch.from_numpy(xw), torch.from_numpy(yw),
                SIGMOID_EMBED)
    pt.fused_mm(tt, torch.from_numpy(x), torch.from_numpy(y), SIGMOID_EMBED,
                backend="reference")
    with pytest.raises(ValueError):
        pt.fused_mm(tt, torch.from_numpy(x), torch.from_numpy(y),
                    SIGMOID_EMBED, backend="xla")


def test_value_gradient_takes_the_plain_route(hub):
    """A graph whose edge values require a gradient runs the plain
    formulation, whose value gradient equals jax.grad's."""
    tg, tt, jg = hub
    op = TDIST_FORCE
    x, y = features(6, 8)
    w = np.random.default_rng(6).normal(size=(N, 8)).astype(np.float32)
    v = tg.value.clone().requires_grad_(True)
    graph = pt.sparse.tiling.TiledGraph(
        graph=tg.with_value(v), fwd=tt.fwd, bwd=tt.bwd, fwd_mm=tt.fwd_mm,
        bwd_mm=tt.bwd_mm)
    out = pt.fused_mm(graph, torch.from_numpy(x), torch.from_numpy(y), op)
    (out * torch.from_numpy(w)).sum().backward()
    jop = jax_op(op)

    def loss(value):
        return jnp.sum(jax_fused_mm(jg.with_value(value), jnp.asarray(x),
                                    jnp.asarray(y), jop, backend="xla") * w)

    want = np.asarray(jax.grad(loss)(jg.value))
    assert_scaled(v.grad.numpy(), want, 1e-4)


def test_fused_matches_jax_pallas_interpret():
    """One tiny case against the JAX v4 Pallas kernel in interpret mode,
    at tests/test_fused.py's 3e-2 (the kernel scatters in bf16); no
    zero-valued edges, no ties."""
    from isplib_tpu.sparse.graph import host_arrays
    from isplib_tpu.sparse.tiling import build_tiling_from_numpy
    tg, tt, jg = graphs(11, num_rows=150, num_cols=140, nnz=900)
    jtiled = build_tiling_from_numpy(jg, host_arrays(jg), rb=128, version=4,
                                     S=2, device=False)
    x, y = features(11, 16, num_rows=150, num_cols=140)
    for op in (SIGMOID_EMBED, TDIST_FORCE):
        got = pt.fused_mm(tt, torch.from_numpy(x), torch.from_numpy(y), op)
        want = np.asarray(jax_fused_mm(jtiled, jnp.asarray(x),
                                       jnp.asarray(y), jax_op(op)))
        assert_scaled(got.numpy(), want, 3e-2)


def test_chunked_plain_versions_equal_one_pass(hub, monkeypatch):
    """The plain formulation and K6's plain version over feature chunks
    equal one pass (the ROP adds the chunks' partial sums)."""
    tg, tt, _ = hub
    x, y = (torch.from_numpy(a) for a in features(12, 41))
    g = torch.from_numpy(features(13, 41)[0])
    op = TDIST_FORCE

    def run():
        return (reference.fused_mm_raw(tg.row, tg.col, tg.value, tg.deg, x,
                                       y, N, op),
                fused_bwd.fused_bwd(tt.fwd_mm, tg.col, tg.value, x, y, g, op,
                                    False),
                fused_bwd.fused_bwd(tt.bwd_mm, tg.csc_col, tg.csc_value, x,
                                    y, g, op, True))

    whole = run()
    monkeypatch.setattr(reference, "CHUNK_BYTES", tg.nnz_padded * 20 * 5)
    assert len(reference._chunks(tg.nnz_padded, 41, 20)) == 9
    for a, b in zip(whole, run()):
        assert_scaled(b.numpy(), a.numpy(), 1e-6)


def test_catalogue_is_callable_with_its_derivative():
    t = torch.linspace(-3, 3, 12, dtype=torch.float64, requires_grad=True)
    for sop in ScalarOp:
        (d,) = torch.autograd.grad(sop(t).sum(), t)
        torch.testing.assert_close(sop.grad(t.detach()), d)
        jt = jnp.asarray(t.detach().numpy())
        np.testing.assert_allclose(sop(t.detach()).numpy(),  # JAX in fp32
                                   np.asarray(JAX_SOP[sop](jt)), rtol=1e-6)


def test_stage_codes_follow_the_kernel_header():
    """The integer codes the kernels take are the header's enums."""
    text = (build.CSRC / "fused_ops.cuh").read_text()
    enums = {m.group(1): [v.split("=")[0].strip()
                          for v in m.group(2).split(",")]
             for m in re.finditer(r"enum (\w+) \{([^}]*)\}", text)}
    assert enums["Vop"] == ["COPY_RHS", "COPY_LHS", "ADD", "SUB", "MUL",
                            "VMAX", "VMIN"]
    assert enums["Rop"] == ["NOOP", "DOT", "NORM2"]
    assert enums["Sop"] == ["SOP_NONE", "SIGMOID", "TDIST"]
    assert enums["Vsc"] == ["VSC_MUL", "VSC_MEAN", "VSC_NONE"]
    assert [v.name for v in VectorOp] == [
        "COPY_RHS", "COPY_LHS", "ADD", "SUB", "MUL", "MAX", "MIN"]
    assert [s.name for s in ScalarOp] == enums["Sop"][1:]
    assert fused.stage_codes(FusedOp(VectorOp.MIN, ReduceOp.NORM2,
                                     ScalarOp.TDIST, ScaleOp.NONE)) == (
        6, 2, 2, 2)
    assert fused.stage_codes(FusedOp.spmm("mean")) == (0, 0, 0, 1)


def test_kernel_wrappers_reject_bad_operands(hub):
    tg, tt, _ = hub
    x, y = (torch.from_numpy(a) for a in features(1, 8))
    ok = (tt.fwd_mm, tg.col, tg.value, tg.deg, x, y, SIGMOID_EMBED)

    def call(i, v):
        args = list(ok)
        args[i] = v
        return fused.fused(*args)

    call(0, tt.fwd_mm)
    with pytest.raises(ValueError):
        call(6, FusedOp(aop=Reduce.MAX))
    with pytest.raises(ValueError):
        call(6, FusedOp(sop=torch.sigmoid))
    with pytest.raises(ValueError):
        call(4, torch.zeros(N, 257))
    with pytest.raises(ValueError):
        call(5, torch.zeros(M + 1, 8))
    with pytest.raises(TypeError):
        call(4, x.double())
    with pytest.raises(ValueError):
        call(4, torch.zeros(8, N).t())
    with pytest.raises(ValueError):
        call(3, tg.deg[:-1])
    with pytest.raises(ValueError):
        fused_bwd.fused_bwd(tt.bwd_mm, tg.csc_col, tg.csc_value, x, y, x,
                            SIGMOID_EMBED, False)  # pass A shapes on Aᵀ


def test_cpu_tensors_launch_nothing(hub):
    tg, tt, _ = hub
    before = (fused.LAUNCHES, fused_bwd.LAUNCHES)
    x, y = features(1, 8)
    port_run(tt, SIGMOID_EMBED, x, y, np.ones((N, 8), np.float32))
    assert (fused.LAUNCHES, fused_bwd.LAUNCHES) == before


def test_segments_of_both_lists_cover_every_edge(hub):
    tg, tt, _ = hub
    for plan, ptr in ((tt.fwd_mm, tg.rowptr), (tt.bwd_mm, tg.csc_colptr)):
        seg = plan.seg_ptr.numpy()
        assert seg[0] == 0 and seg[-1] == tg.nnz == plan.nnz
        assert np.diff(seg).max() <= SEG_EDGES
        rows = plan.seg_row.numpy()
        assert np.all(seg[:-1] >= ptr.numpy()[rows])
        assert np.all(seg[1:] <= ptr.numpy()[rows + 1])
    assert (tt.bwd_mm.num_rows, tt.bwd_mm.num_cols) == (M, N)


def test_port_imports_no_jax():
    """The port, its new modules included, imports neither JAX nor the JAX
    package."""
    code = ("import sys, isplib_tpu_torch, isplib_tpu_torch.ops.fused, "
            "isplib_tpu_torch.kernels.sddmm, isplib_tpu_torch.kernels.fused,"
            " isplib_tpu_torch.kernels.fused_bwd, isplib_tpu_torch.run_model,"
            " isplib_tpu_torch.run_all;"
            " bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'isplib_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
