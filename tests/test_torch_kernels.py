"""The port's CUDA kernels and their wrappers, without JAX.

On a machine without a card the wrapper and build checks run and the
kernel tests skip.  On a card (where JAX need not be installed) run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

to hold each kernel against its plain version; ``chip_smoke.py`` does the
same at the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import isplib_tpu_torch as pt
from isplib_tpu_torch.dist import LocalMesh, partition_rows, spmm_sharded
from isplib_tpu_torch.kernels import (build, fused, fused_bwd, sddmm,
                                      spmm_bsr, spmm_bsr_v3, spmm_minmax,
                                      spmm_minmax_v4, spmm_rowblock,
                                      spmm_stream, spmm_v2)
from isplib_tpu_torch.ops.semiring import (FusedOp, Reduce, ReduceOp,
                                           ScalarOp, ScaleOp, VectorOp)
from isplib_tpu_torch.sparse.tiling import (SEG_SLOTS, build_plan_v1_arrays,
                                            build_tiling)
from isplib_tpu_torch.sparse.tiling_v2 import (build_plan_v2_arrays,
                                               derive_v2_minmax_schedule,
                                               derive_v2_schedule)
from isplib_tpu_torch.sparse.minmax_sched import ITEM_EDGES
from isplib_tpu_torch.sparse.tiling_v3 import build_plan_v3_arrays
from isplib_tpu_torch.sparse.tiling_v4mm import derive_minmax_schedule
from isplib_tpu_torch.sparse.tiling_v5 import (SEG_EDGES, build_hybrid_plan,
                                               derive_block_schedule)


def hub_graph(device, num_rows=1200, num_cols=1100, nnz=6000):
    """A dense 256x256 corner (densified at threshold 128), uniform edges
    (residual), a hub row of three segments and an empty row (301)."""
    rng = np.random.default_rng(0)
    nh = nnz // 2
    row = np.concatenate([rng.integers(0, 256, nh),
                          rng.integers(0, num_rows, nnz - nh),
                          np.full(2 * SEG_EDGES + 10, 300)])
    col = np.concatenate([rng.integers(0, 256, nh),
                          rng.integers(0, num_cols, nnz - nh),
                          rng.integers(0, num_cols, 2 * SEG_EDGES + 10)])
    keep = row != 301
    row, col = row[keep], col[keep]
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    return pt.from_edge_index(np.stack([col, row]), num_nodes=num_rows,
                              num_src_nodes=num_cols, edge_value=val,
                              edge_multiple=128, device=device)


@pytest.fixture(scope="module")
def plan_cpu():
    return build_tiling(hub_graph("cpu"), dense_threshold=128).fwd


def test_wrappers_reject_bad_operands(plan_cpu):
    plan = plan_cpu
    with pytest.raises(TypeError):
        spmm_bsr.spmm_bsr(plan, torch.zeros(plan.num_cols, 8,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        spmm_bsr.spmm_bsr(plan, torch.zeros(plan.num_cols + 1, 8))
    with pytest.raises(ValueError):
        spmm_bsr.spmm_bsr(plan, torch.zeros(8, plan.num_cols).t())
    with pytest.raises(ValueError):
        spmm_bsr.spmm_bsr(plan, torch.zeros(plan.num_cols, 8,
                                            device="meta"))
    with pytest.raises(ValueError):
        spmm_stream.spmm_stream(plan, torch.zeros(plan.num_cols, 8),
                                torch.zeros(plan.num_rows, 9))


def test_minmax_wrapper_rejects_bad_operands():
    g = hub_graph("cpu")
    plan = build_tiling(g).fwd_mm
    x = torch.zeros(g.num_cols, 8)
    ok = (plan, g.col, g.value, x, "max", g.nnz_padded - 1)

    def call(i, v):
        args = list(ok)
        args[i] = v
        return spmm_minmax_v4.spmm_minmax_v4(*args)

    call(0, plan)  # the operands as given are accepted
    with pytest.raises(TypeError):
        call(3, x.double())
    with pytest.raises(TypeError):
        call(1, g.col.long())
    with pytest.raises(ValueError):
        call(3, torch.zeros(g.num_cols + 1, 8))
    with pytest.raises(ValueError):
        call(3, torch.zeros(8, g.num_cols).t())
    with pytest.raises(ValueError):
        call(3, torch.zeros(g.num_cols, 8, device="meta"))
    with pytest.raises(ValueError):
        call(2, g.value[:-1])
    with pytest.raises(ValueError):
        call(4, "sum")
    with pytest.raises(ValueError):
        call(5, g.nnz - 1)  # a real edge cannot be the sentinel


def test_cpu_tensors_take_the_plain_versions(plan_cpu):
    """No launch is counted for a CPU tensor."""
    before = (spmm_bsr.LAUNCHES, spmm_stream.LAUNCHES,
              spmm_minmax_v4.LAUNCHES)
    x = torch.randn(plan_cpu.num_cols, 8)
    out = spmm_bsr.spmm_bsr(plan_cpu, x)
    spmm_stream.spmm_stream(plan_cpu, x, out)
    g = hub_graph("cpu")
    pt.spmm(build_tiling(g), x, "max")
    assert (spmm_bsr.LAUNCHES, spmm_stream.LAUNCHES,
            spmm_minmax_v4.LAUNCHES) == before


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_build_flags_and_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert names == ["fused.cu", "fused_bwd.cu", "sddmm.cu", "spmm_bsr.cu",
                     "spmm_bsr_v3.cu", "spmm_minmax.cu", "spmm_minmax_v4.cu",
                     "spmm_rowblock.cu", "spmm_stream.cu", "spmm_v2.cu"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernels "
                    "against their plain versions on the H100")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_kernels_match_plain_versions(cuda, k, direction):
    """Same rounding on both sides, so only the sum order differs."""
    tiled = build_tiling(hub_graph(cuda), dense_threshold=128)
    plan = tiled.fwd if direction == "fwd" else tiled.bwd
    assert plan.nb > 0 and plan.nseg > 0
    x = torch.randn(plan.num_cols, k, device=cuda)
    before = (spmm_bsr.LAUNCHES, spmm_stream.LAUNCHES)
    got = spmm_bsr.spmm_bsr(plan, x)
    want = spmm_bsr.spmm_bsr_plain(plan, x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    got_s, want_s = torch.zeros_like(got), torch.zeros_like(want)
    spmm_stream.spmm_stream(plan, x, got_s)
    spmm_stream.spmm_stream_plain(plan, x, want_s)
    torch.cuda.synchronize()
    assert float((got_s - want_s).abs().max()) <= 1e-4 * float(
        want_s.abs().max())
    assert (spmm_bsr.LAUNCHES, spmm_stream.LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)


def zero_tie_graph(device, num_rows=900, num_cols=700):
    """Unit and zero edge values with rounded x, so products tie and ±0.0
    meet; a hub row (5) of 12 segments, rows of 1-3 segments and empty rows
    (the last 100)."""
    rng = np.random.default_rng(1)
    row = np.concatenate([rng.integers(0, num_rows - 100, 20000),
                          np.full(12 * SEG_EDGES - 7, 5)])
    col = rng.integers(0, num_cols, row.shape[0])
    val = np.where(rng.random(row.shape[0]) < 0.2, 0.0, 1.0).astype(
        np.float32)
    val[rng.random(row.shape[0]) < 0.1] = -1.0
    return pt.from_edge_index(np.stack([col, row]), num_nodes=num_rows,
                              num_src_nodes=num_cols, edge_value=val,
                              edge_multiple=128, device=device)


def dense_block_graph(device, n=640):
    """Every 128x128 block dense (~300 edges: rows read the same x rows),
    unit, zero and -1 values (ties on rounded x, ±0.0 products), the last
    20 rows empty."""
    rng = np.random.default_rng(3)
    row = rng.integers(0, n - 20, 8000)
    col = rng.integers(0, n, 8000)
    val = rng.choice(np.float32([-1.0, 0.0, 1.0]), 8000, p=[0.3, 0.2, 0.5])
    return pt.from_edge_index(np.stack([col, row]), num_nodes=n,
                              edge_value=val, edge_multiple=128,
                              device=device)


MINMAX_GRAPHS = {"hub": hub_graph, "ties": zero_tie_graph,
                 "dense": dense_block_graph}
# the max/min walk's schedules: the plan's own (items of 256 edges: the
# main path's), and items of 16 edges (rows split over items everywhere)
MINMAX_SCHEDULES = {"default": {}, "gather-16": dict(item_edges=16)}


def check_minmax_schedule(s, sched, graph):
    """The schedule cuts items as it is there to, with split rows where
    a row outgrows them."""
    assert s.item_edges == MINMAX_SCHEDULES[sched].get("item_edges",
                                                       ITEM_EDGES)
    assert s.nsplit > 0 or (sched == "default" and graph == "dense")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130, 602])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("graph", sorted(MINMAX_GRAPHS))
@pytest.mark.parametrize("sched", sorted(MINMAX_SCHEDULES))
def test_minmax_kernel_matches_plain_version(cuda, sched, graph, reduce, k):
    """Exact fp32 on both sides: values equal bit for bit (the winner's own
    product, so also the sign of a zero), args equal; each graph over the
    plan's own schedule and over items of 16 edges."""
    g = MINMAX_GRAPHS[graph](cuda)
    plan = build_tiling(g).fwd_mm
    if MINMAX_SCHEDULES[sched]:
        plan = dataclasses.replace(plan, sched=derive_minmax_schedule(
            plan, **MINMAX_SCHEDULES[sched]))
    check_minmax_schedule(plan.sched, sched, graph)
    x = torch.randn(g.num_cols, k, device=cuda)
    if graph != "hub":
        x = x.round()
    before = spmm_minmax_v4.LAUNCHES
    got = spmm_minmax_v4.spmm_minmax_v4(plan, g.col, g.value, x, reduce,
                                        g.nnz_padded - 1)
    want = spmm_minmax_v4.spmm_minmax_v4_plain(plan, g.col, g.value, x,
                                               reduce, g.nnz_padded - 1)
    torch.cuda.synchronize()
    assert spmm_minmax_v4.LAUNCHES == before + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_spmm_on_cuda_runs_the_kernel(cuda, reduce):
    """A CUDA TiledGraph launches K3; a CUDA CSRGraph runs the
    reference path, with the same values and args."""
    g = hub_graph(cuda)
    tiled = build_tiling(g)
    x = torch.randn(g.num_cols, 41, device=cuda)
    before = spmm_minmax_v4.LAUNCHES
    got = pt.spmm(tiled, x, reduce)
    assert spmm_minmax_v4.LAUNCHES == before + 1
    want = pt.spmm(g, x, reduce)
    assert spmm_minmax_v4.LAUNCHES == before + 1
    assert torch.equal(got, want)


def hub_rows_and_cols(device, num_rows=1200, num_cols=1100, nnz=20000,
                      edgeless_first=False):
    """A hub row and a hub column (among 0, 1) of many segments each, so
    both work lists have split rows, and empty rows (the last 50); with
    ``edgeless_first`` row 0 and column 0 have no edges either (the hubs
    are among 1, 2)."""
    rng = np.random.default_rng(2)
    lo = int(edgeless_first)
    row = rng.integers(lo, num_rows - 50, nnz)
    col = rng.integers(lo, num_cols, nnz)
    row[rng.random(nnz) < 0.2] = rng.integers(lo, lo + 2)
    col[rng.random(nnz) < 0.2] = rng.integers(lo, lo + 2)
    val = rng.normal(size=nnz).astype(np.float32)
    return pt.from_edge_index(np.stack([col, row]), num_nodes=num_rows,
                              num_src_nodes=num_cols, edge_value=val,
                              edge_multiple=128, device=device)


def assert_near_plain(got, want):
    """fp32 on both sides, only the sum order differs."""
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130, 300])
def test_sddmm_kernel_matches_plain_version(cuda, k):
    g = hub_rows_and_cols(cuda)
    plan = build_tiling(g).fwd_mm
    assert plan.nsplit > 0
    a = torch.randn(g.num_rows, k, device=cuda)
    b = torch.randn(g.num_cols, k, device=cuda)
    before = sddmm.LAUNCHES
    got = sddmm.sddmm(plan, g.col, a, b)
    want = sddmm.sddmm_plain(plan, g.col, a, b)
    torch.cuda.synchronize()
    assert sddmm.LAUNCHES == before + 1
    assert_near_plain(got, want)
    assert not bool(got[g.nnz:].any())


FUSED_OPS = [
    FusedOp(VectorOp.MUL, ReduceOp.DOT, ScalarOp.SIGMOID, ScaleOp.MUL),
    FusedOp(VectorOp.SUB, ReduceOp.NORM2, ScalarOp.TDIST, ScaleOp.MUL),
    FusedOp.spmm("mean"),
    FusedOp.sddmm_dot(),
    FusedOp(VectorOp.MAX, ReduceOp.NORM2, ScalarOp.SIGMOID, ScaleOp.NONE),
    FusedOp(VectorOp.COPY_LHS, ReduceOp.NOOP, ScalarOp.TDIST, ScaleOp.MEAN),
    FusedOp(VectorOp.MIN, ReduceOp.DOT, None, ScaleOp.MUL),
    FusedOp(VectorOp.ADD, ReduceOp.NORM2, None, ScaleOp.NONE),
]


def check_fused_kernels(g, x, y, gr, op):
    """K5 forward and both K6 passes on ``g`` against their plain
    versions, each launched once."""
    tiled = build_tiling(g)
    assert tiled.fwd_mm.nsplit > 0 and tiled.bwd_mm.nsplit > 0
    before = (fused.LAUNCHES, fused_bwd.LAUNCHES)
    fwd = (tiled.fwd_mm, g.col, g.value, g.deg, x, y, op)
    assert_near_plain(fused.fused(*fwd), fused.fused_plain(*fwd))
    for plan, col, val, pass_b in (
            (tiled.fwd_mm, g.col, g.value, False),
            (tiled.bwd_mm, g.csc_col, g.csc_value, True)):
        args = (plan, col, val, x, y, gr, op, pass_b)
        assert_near_plain(fused_bwd.fused_bwd(*args),
                          fused_bwd.fused_bwd_plain(*args))
    torch.cuda.synchronize()
    assert (fused.LAUNCHES, fused_bwd.LAUNCHES) == (before[0] + 1,
                                                    before[1] + 2)


@pytest.mark.parametrize("op", FUSED_OPS, ids=lambda o: o.vop.value)
def test_fused_zero_padding_changes_nothing(op):
    """The wrappers pad a ragged K with zero features up to a multiple of 4
    for the kernels' float4 rows and keep the first K columns: the plain
    versions on padded operands give the unpadded result there (a zero
    feature adds 0 to t and to <g, v>; the padded columns are dropped)."""
    g = hub_rows_and_cols("cpu")
    tiled = build_tiling(g)
    rng = np.random.default_rng(4)
    x, y, gr = (torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
                for n in (g.num_rows, g.num_cols, g.num_rows))
    xp = fused.pad4(x)
    assert xp.shape == (g.num_rows, 8) and fused.pad4(xp) is xp
    runs = [lambda a, b, c: fused.fused_plain(tiled.fwd_mm, g.col, g.value,
                                              g.deg, a, b, op)]
    for plan, col, val, pass_b in (
            (tiled.fwd_mm, g.col, g.value, False),
            (tiled.bwd_mm, g.csc_col, g.csc_value, True)):
        runs.append(lambda a, b, c, plan=plan, col=col, val=val,
                    pass_b=pass_b: fused_bwd.fused_bwd_plain(
                        plan, col, val, a, b, c, op, pass_b))
    for run in runs:
        want = run(x, y, gr)
        got = run(fused.pad4(x), fused.pad4(y), fused.pad4(gr))
        torch.testing.assert_close(fused.unpad(got, 5), want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 8, 32, 41, 64, 128, 256])
@pytest.mark.parametrize("op", FUSED_OPS, ids=lambda o: o.vop.value)
def test_fused_kernels_match_plain_versions(cuda, op, k):
    """K5 forward and both K6 passes against their plain versions at
    every lane-group width, with hub rows and columns split across
    segments and rows without edges."""
    g = hub_rows_and_cols(cuda)
    assert int((g.deg == 0).sum()) > 0
    check_fused_kernels(g, 0.5 * torch.randn(g.num_rows, k, device=cuda),
                        0.5 * torch.randn(g.num_cols, k, device=cuda),
                        torch.randn(g.num_rows, k, device=cuda), op)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 32, 41, 256])
@pytest.mark.parametrize("op", FUSED_OPS, ids=lambda o: o.vop.value)
def test_fused_kernels_with_edgeless_first_row_and_column(cuda, op, k):
    """Row 0 and column 0 without edges: the first segment of both work
    lists is empty and starts at edge 0 (the kernels read no edge word for
    it, none lies before it), and its row is stored as zeros."""
    g = hub_rows_and_cols(cuda, edgeless_first=True)
    tiled = build_tiling(g)
    for plan in (tiled.fwd_mm, tiled.bwd_mm):
        assert plan.seg_ptr[:2].tolist() == [0, 0]
        assert int(plan.seg_row[0]) == 0
    check_fused_kernels(g, 0.5 * torch.randn(g.num_rows, k, device=cuda),
                        0.5 * torch.randn(g.num_cols, k, device=cuda),
                        torch.randn(g.num_rows, k, device=cuda), op)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [32, 41])
@pytest.mark.parametrize("vop", [VectorOp.MAX, VectorOp.MIN, VectorOp.MUL])
def test_fused_kernels_zero_values_and_ties(cuda, vop, k):
    """Zero-valued edges count under ScaleOp.NONE, and VOP max/min ties
    (operands on a grid of quarters) split the cotangent 0.5 / 0.5."""
    g = hub_rows_and_cols(cuda)
    n = g.nnz
    val = g.value.clone()
    val[:n][torch.rand(n, device=cuda, generator=torch.Generator(
        cuda).manual_seed(3)) < 0.3] = 0.0
    g = g.with_value(val)
    assert int((g.value[:n] == 0).sum()) > 0

    def grid(rows):
        return 0.25 * torch.randint(-2, 3, (rows, k), device=cuda).float()

    x, y = grid(g.num_rows), grid(g.num_cols)
    for op in (FusedOp(vop, ReduceOp.NORM2, ScalarOp.SIGMOID, ScaleOp.NONE),
               FusedOp(vop, ReduceOp.NOOP, None, ScaleOp.NONE)):
        check_fused_kernels(g, x, y, torch.randn(g.num_rows, k, device=cuda),
                            op)


@pytest.mark.gpu
@pytest.mark.parametrize("x_grad", [True, False])
def test_fused_mm_on_cuda_runs_the_kernels(cuda, x_grad):
    """A CUDA TiledGraph launches K5 forward and K6 backward (pass B
    alone when x needs no gradient) and agrees with the plain formulation
    on the CSRGraph."""
    g = hub_rows_and_cols(cuda)
    tiled = build_tiling(g)
    op = FUSED_OPS[1]
    outs, grads = [], []
    for graph in (tiled, g):
        x = torch.randn(g.num_rows, 32, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
        y = torch.randn(g.num_cols, 32, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
        x.requires_grad_(x_grad)
        y.requires_grad_(True)
        before = (fused.LAUNCHES, fused_bwd.LAUNCHES)
        out = pt.fused_mm(graph, x, y, op)
        (out ** 2).sum().backward()
        ran = (fused.LAUNCHES - before[0], fused_bwd.LAUNCHES - before[1])
        assert ran == ((1, 1 + x_grad) if graph is tiled else (0, 0))
        outs.append(out.detach())
        grads += [x.grad, y.grad]
    assert_near_plain(outs[0], outs[1])
    if x_grad:
        assert_near_plain(grads[0], grads[2])
    else:
        assert grads[0] is None and grads[2] is None
    assert_near_plain(grads[1], grads[3])


def v2_case(device, geometry, ties, k, with_eids=True, graph=None):
    """A v2 plan (with edge ids: K7's) of hub_graph's (or
    zero_tie_graph's, or the ``MINMAX_GRAPHS`` entry ``graph``'s) edges
    with ``geometry`` = (rb, ct, eb), and x (rounded where values tie)."""
    ties = ties or graph in ("ties", "dense")
    graph = graph or ("ties" if ties else "hub")
    g = MINMAX_GRAPHS[graph]("cpu")
    n = g.nnz
    rb, ct, eb = geometry
    plan = build_plan_v2_arrays(
        g.row[:n].numpy(), g.col[:n].numpy(), g.value[:n].numpy(),
        g.num_rows, g.num_cols, rb=rb, ct=ct, eb=eb, k=k,
        with_eids=with_eids, device=device)
    x = torch.randn(g.num_cols, k, device=device)
    return plan, (x.round() if ties else x), g.nnz_padded - 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130, 602])
@pytest.mark.parametrize("geometry", [(128, 128, 512), (256, 512, 512)])
def test_v2_sum_kernel_matches_plain_version(cuda, geometry, k):
    """K8: fp32 on both sides, only the sum order differs (atomics)."""
    plan, x, _ = v2_case(cuda, geometry, False, k, with_eids=False)
    before = spmm_v2.LAUNCHES
    got = spmm_v2.spmm_v2(plan, x)
    want = spmm_v2.spmm_v2_plain(plan, x)
    torch.cuda.synchronize()
    assert spmm_v2.LAUNCHES == before + 1
    assert_near_plain(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130, 602])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("graph", sorted(MINMAX_GRAPHS))
@pytest.mark.parametrize("sched", sorted(MINMAX_SCHEDULES))
@pytest.mark.parametrize("geometry", [(128, 128, 512), (256, 512, 512)])
def test_v2_minmax_kernel_matches_plain_version(cuda, geometry, sched, graph,
                                                reduce, k):
    """K7: exact fp32 on both sides, values bit for bit, args equal; the
    schedules as in test_minmax_kernel_matches_plain_version."""
    plan, x, sentinel = v2_case(cuda, geometry, False, k, graph=graph)
    if MINMAX_SCHEDULES[sched]:
        plan = dataclasses.replace(plan, mm_sched=derive_v2_minmax_schedule(
            plan, **MINMAX_SCHEDULES[sched]))
    check_minmax_schedule(plan.mm_sched, sched, graph)
    before = spmm_minmax.LAUNCHES
    got = spmm_minmax.spmm_minmax_v2(plan, x, reduce, sentinel)
    want = spmm_minmax.spmm_minmax_v2_plain(plan, x, reduce, sentinel)
    torch.cuda.synchronize()
    assert spmm_minmax.LAUNCHES == before + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("version", [2, 5])
def test_sharded_spmm_on_cuda_runs_the_kernels(cuda, version):
    """A 4-shard LocalMesh on the card: sum through K8 (or K1/K2) and max
    through K7, forward and grad, against the same partition's reference
    route."""
    g = hub_graph("cpu", num_rows=1200, num_cols=1200)
    n = g.nnz
    args = (g.row[:n].numpy(), g.col[:n].numpy(), g.value[:n].numpy(),
            1200, 4)
    tiled = partition_rows(*args, tiling=dict(version=version),
                           device=cuda)
    plain = partition_rows(*args, device=cuda)
    w = torch.randn(1200, 41, device=cuda)
    for red, mod in (("sum", spmm_v2 if version == 2 else spmm_bsr),
                     ("max", spmm_minmax)):
        outs = []
        for sg in (tiled, plain):
            x = torch.randn(1200, 41, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(0))
            x.requires_grad_(True)
            before = mod.LAUNCHES
            out = spmm_sharded(sg, x, red, mesh=LocalMesh(4))
            (out * w).sum().backward()
            assert (mod.LAUNCHES > before) == (sg is tiled)
            outs.append((out.detach(), x.grad))
        (o1, g1), (o2, g2) = outs
        if red == "max":  # exact values; the grads add in another order
            assert torch.equal(o1, o2)
            assert float((g1 - g2).abs().max()) <= 1e-5 * float(
                g2.abs().max())
        else:  # the v5 route's dense half rounds to bf16
            tol = 1e-4 if version == 2 else 2e-2
            assert float((o1 - o2).abs().max()) <= tol * float(
                o2.abs().max())
            assert float((g1 - g2).abs().max()) <= tol * float(
                g2.abs().max())


def coo_of(g):
    n = g.nnz
    return (g.row[:n].cpu().numpy(), g.col[:n].cpu().numpy(),
            g.value[:n].cpu().numpy(), g.num_rows, g.num_cols)


def test_v1_v3_wrappers_reject_bad_operands():
    g = hub_graph("cpu")
    p1 = build_plan_v1_arrays(*coo_of(g), device="cpu")
    p3 = build_plan_v3_arrays(*coo_of(g), dense_threshold=16,
                              device="cpu").bsr
    for call in (lambda x: spmm_rowblock.spmm_rowblock(p1, x),
                 lambda x: spmm_bsr_v3.spmm_bsr_v3(p3, x)):
        with pytest.raises(TypeError):
            call(torch.zeros(g.num_cols, 8, dtype=torch.float64))
        with pytest.raises(ValueError):
            call(torch.zeros(g.num_cols + 1, 8))
        with pytest.raises(ValueError):
            call(torch.zeros(8, g.num_cols).t())
        with pytest.raises(ValueError):
            call(torch.zeros(g.num_cols, 8, device="meta"))
    before = (spmm_rowblock.LAUNCHES, spmm_bsr_v3.LAUNCHES)
    spmm_rowblock.spmm_rowblock(p1, torch.zeros(g.num_cols, 8))
    spmm_bsr_v3.spmm_bsr_v3(p3, torch.zeros(g.num_cols, 8))
    assert (spmm_rowblock.LAUNCHES, spmm_bsr_v3.LAUNCHES) == before


def split_graph(device, num_rows=1000, num_cols=5000):
    """Row block 0 dense over all 40 block columns (a hub row block: more
    members than a K9 piece takes), row 5 a hub row of 600 edges (more
    slots than a K10 work item takes), uniform edges elsewhere, and rows
    384-511 without edges (empty row blocks at 128 and below)."""
    rng = np.random.default_rng(1)
    row = np.concatenate([rng.integers(0, 128, 40 * 40),
                          rng.integers(0, num_rows, 1500),
                          np.full(600, 5)])
    col = np.concatenate([np.repeat(np.arange(40) * 124, 40)
                          + rng.integers(0, 124, 40 * 40),
                          rng.integers(0, num_cols, 1500),
                          rng.integers(0, num_cols, 600)])
    keep = (row < 384) | (row >= 512)
    row, col = row[keep], col[keep]
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    return pt.from_edge_index(np.stack([col, row]), num_nodes=num_rows,
                              num_src_nodes=num_cols, edge_value=val,
                              edge_multiple=128, device=device)


def coo_case(variant, direction):
    """(row, col, val, num_rows, num_cols) of a test graph or of its
    transpose, on the host."""
    g = hub_graph("cpu") if variant == "hub" else split_graph("cpu")
    row, col, val, r, c = coo_of(g)
    if direction == "bwd":
        order = np.lexsort((row, col))
        return col[order], row[order], val[order], c, r
    return row, col, val, r, c


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32, 41, 130, 602])
@pytest.mark.parametrize("geometry", [(256, 512, 512), (128, 128, 128),
                                      (64, 64, 256)])
@pytest.mark.parametrize("variant", ["hub", "split"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_rowblock_kernel_matches_plain_version(cuda, geometry, k, variant,
                                               direction):
    """K10: fp32 on both sides, only the sum order differs (atomics where a
    row is cut into several work items); hub rows, empty rows and row
    blocks, the plans of A and of Aᵀ."""
    plan = build_plan_v1_arrays(*coo_case(variant, direction), *geometry,
                                device=cuda)
    if variant == "split" and direction == "fwd":
        assert int(plan.sched.row_ptr.diff().max()) > SEG_SLOTS
    x = torch.randn(plan.num_cols, k, device=cuda)
    before = spmm_rowblock.LAUNCHES
    got = spmm_rowblock.spmm_rowblock(plan, x)
    want = spmm_rowblock.spmm_rowblock_plain(plan, x)
    torch.cuda.synchronize()
    assert spmm_rowblock.LAUNCHES == before + 1
    assert_near_plain(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32, 41, 96, 130, 602])
@pytest.mark.parametrize("g, vmem", [(4, 6 << 20), (16, 6 << 20),
                                     (2, 1 << 15)])
@pytest.mark.parametrize("variant", ["hub", "split"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_bsr_v3_kernel_matches_plain_version(cuda, g, vmem, k, variant,
                                             direction):
    """K9: the same bf16 rounding on both sides, only the sum order differs
    (atomics where a hub row block is cut into pieces); group pads are
    skipped, several superblocks where vmem is small, row blocks without
    members are zeroed, the plans of A and of Aᵀ."""
    plan = build_plan_v3_arrays(*coo_case(variant, direction), rb=128,
                                ct=128, eb=128, dense_threshold=16, g=g, k=k,
                                vmem_out_bytes=vmem, device=cuda).bsr
    assert plan.nb > 0
    if variant == "split" and direction == "fwd":
        assert int(plan.sched.pieces[:, 3].sum()) > 0
        assert plan.sched.zero_rbs.numel() > 0
    x = torch.randn(plan.num_cols, k, device=cuda)
    before = spmm_bsr_v3.LAUNCHES
    got = spmm_bsr_v3.spmm_bsr_v3(plan, x)
    want = spmm_bsr_v3.spmm_bsr_v3_plain(plan, x)
    torch.cuda.synchronize()
    assert spmm_bsr_v3.LAUNCHES == before + 1
    assert_near_plain(got, want)


KERNELS_OF_VERSION = {5: (spmm_bsr, spmm_stream), 4: (spmm_stream,),
                      3: (spmm_bsr_v3, spmm_v2), 2: (spmm_v2,),
                      1: (spmm_rowblock,)}


@pytest.mark.gpu
@pytest.mark.parametrize("version", [1, 2, 3, 4, 5])
def test_versions_on_cuda_run_their_kernels(cuda, version):
    """spmm forward and grad_x through a TiledGraph of each version launch
    that version's kernels (twice: A, then Aᵀ) and agree with the
    reference path (2e-2 where bf16 blocks carry edges)."""
    g = hub_graph(cuda)
    kw = {3: dict(dense_threshold=16, g=4, rb=128, ct=128),
          5: dict(dense_threshold=16)}.get(version, {})
    tiled = build_tiling(g, version=version, k=41, **kw)
    mods = KERNELS_OF_VERSION[version]
    w = torch.randn(g.num_rows, 41, device=cuda)
    outs = []
    for graph in (tiled, g):
        x = torch.randn(g.num_cols, 41, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
        x.requires_grad_(True)
        before = [m.LAUNCHES for m in mods]
        out = pt.spmm(graph, x, "mean")
        (out * w).sum().backward()
        torch.cuda.synchronize()
        ran = [m.LAUNCHES - b for m, b in zip(mods, before)]
        assert ran == [2 if graph is tiled else 0] * len(mods)
        outs.append((out.detach(), x.grad))
    tol = 2e-2 if version in (3, 5) else 1e-4
    for got, want in zip(outs[0], outs[1]):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


# ---------------------------------------------------------------------------
# K2 and K8 over their schedules: forced splits, K8's two output modes, and
# the wrappers' contract for plans without a schedule
# ---------------------------------------------------------------------------

def test_v2_v5_cpu_tensors_run_the_plain_versions_without_schedules():
    """On the CPU the wrappers run the plain versions whatever the plan's
    schedule (a plan from an old cache has none) and count no launch."""
    row, col, val, r, c = coo_case("split", "fwd")
    p5 = build_hybrid_plan(row, col, val, r, c, "cpu", dense_threshold=16)
    p2 = build_plan_v2_arrays(row, col, val, r, c, device="cpu")
    assert p5.sched is not None and p2.sched is not None
    x = torch.randn(c, 8)
    before = (spmm_bsr.LAUNCHES, spmm_v2.LAUNCHES)
    for plan, call in ((p5, spmm_bsr.spmm_bsr), (p2, spmm_v2.spmm_v2)):
        want = call(plan, x)
        got = call(dataclasses.replace(plan, sched=None), x)
        assert torch.equal(got, want)
    out = torch.ones(r, 8)
    spmm_v2.spmm_v2(dataclasses.replace(p2, sched=None), x, out)
    assert torch.allclose(out, 1 + spmm_v2.spmm_v2_plain(p2, x))
    assert (spmm_bsr.LAUNCHES, spmm_v2.LAUNCHES) == before


@pytest.mark.gpu
def test_v2_v5_wrappers_raise_without_schedules(cuda):
    """For a CUDA tensor a plan without its schedule raises: the old
    kernels are gone and no plain version stands in."""
    row, col, val, r, c = coo_case("split", "fwd")
    p5 = build_hybrid_plan(row, col, val, r, c, cuda, dense_threshold=16)
    p2 = build_plan_v2_arrays(row, col, val, r, c, device=cuda)
    x = torch.randn(c, 8, device=cuda)
    with pytest.raises(ValueError, match="K2 schedule"):
        spmm_bsr.spmm_bsr(dataclasses.replace(p5, sched=None), x)
    with pytest.raises(ValueError, match="K8 schedule"):
        spmm_v2.spmm_v2(dataclasses.replace(p2, sched=None), x)


def test_minmax_cpu_tensors_run_the_plain_versions_without_schedules():
    """K3 and K7 on the CPU run their plain versions whatever the plan's
    schedule, and count no launch."""
    g = hub_graph("cpu")
    p3 = build_tiling(g).fwd_mm
    p7, x, sentinel = v2_case("cpu", (128, 128, 512), False, 8)
    x3 = torch.randn(g.num_cols, 8)
    before = (spmm_minmax_v4.LAUNCHES, spmm_minmax.LAUNCHES)
    for call, plan, args, field in (
            (spmm_minmax_v4.spmm_minmax_v4, p3,
             (g.col, g.value, x3, "max", g.nnz_padded - 1), "sched"),
            (spmm_minmax.spmm_minmax_v2, p7, (x, "min", sentinel),
             "mm_sched")):
        assert getattr(plan, field) is not None
        want = call(plan, *args)
        got = call(dataclasses.replace(plan, **{field: None}), *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (spmm_minmax_v4.LAUNCHES, spmm_minmax.LAUNCHES) == before


@pytest.mark.gpu
def test_minmax_wrappers_raise_without_schedules(cuda):
    """For a CUDA tensor a max/min plan without its schedule raises: the
    old kernels are gone and no plain version stands in."""
    g = hub_graph(cuda)
    p3 = build_tiling(g).fwd_mm
    p7, x, sentinel = v2_case(cuda, (128, 128, 512), False, 8)
    with pytest.raises(ValueError, match="K3 schedule"):
        spmm_minmax_v4.spmm_minmax_v4(
            dataclasses.replace(p3, sched=None), g.col, g.value,
            torch.randn(g.num_cols, 8, device=cuda), "max",
            g.nnz_padded - 1)
    with pytest.raises(ValueError, match="K7 schedule"):
        spmm_minmax.spmm_minmax_v2(dataclasses.replace(p7, mm_sched=None),
                                   x, "max", sentinel)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32, 41, 96, 130, 602])
@pytest.mark.parametrize("piece_blocks", [4, 32])
@pytest.mark.parametrize("variant", ["hub", "split"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_bsr_kernel_pieces_match_plain_version(cuda, piece_blocks, k,
                                               variant, direction):
    """K2 over its schedule, block-rows cut into pieces of 4 blocks (most
    block-rows split) or 32: the same bf16 rounding on both sides, only
    the sum order differs; block-rows without blocks are zeroed."""
    row, col, val, r, c = coo_case(variant, direction)
    plan = build_hybrid_plan(row, col, val, r, c, cuda, dense_threshold=16)
    plan = dataclasses.replace(plan, sched=derive_block_schedule(
        plan, piece_blocks=piece_blocks))
    assert plan.nb > 0
    if variant == "split" and direction == "fwd":
        assert int(plan.sched.pieces[:, 3].sum()) > 0
        assert plan.sched.zero_rbs.numel() > 0
    x = torch.randn(plan.num_cols, k, device=cuda)
    before = spmm_bsr.LAUNCHES
    got = spmm_bsr.spmm_bsr(plan, x)
    want = spmm_bsr.spmm_bsr_plain(plan, x)
    torch.cuda.synchronize()
    assert spmm_bsr.LAUNCHES == before + 1
    assert_near_plain(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 32, 41, 130, 602])
@pytest.mark.parametrize("seg_slots", [32, 256])
@pytest.mark.parametrize("mode", ["write", "add"])
@pytest.mark.parametrize("variant", ["hub", "split"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_v2_sum_kernel_modes_match_plain_version(cuda, mode, seg_slots, k,
                                                 variant, direction):
    """K8 over its schedule, rows cut into items of 32 slots (hub rows
    split) or 256: a fresh output (rows without slots written as zeros,
    over garbage the pre-pass must clear) and an output it adds into."""
    row, col, val, r, c = coo_case(variant, direction)
    plan = build_plan_v2_arrays(row, col, val, r, c, rb=128, ct=128,
                                eb=512, device=cuda)
    plan = dataclasses.replace(plan, sched=derive_v2_schedule(
        plan, seg_slots=seg_slots))
    if direction == "fwd":
        assert int((plan.sched.row_ptr.diff() > seg_slots).sum()) > 0
        assert int((plan.sched.row_ptr.diff() == 0).sum()) > 0
    x = torch.randn(plan.num_cols, k, device=cuda)
    base = torch.randn(plan.num_rows, k, device=cuda)
    before = spmm_v2.LAUNCHES
    # garbage where the caching allocator will likely place the output
    torch.empty(plan.num_rows, k, device=cuda).fill_(float("nan"))
    if mode == "write":
        got = spmm_v2.spmm_v2(plan, x)
        want = spmm_v2.spmm_v2_plain(plan, x)
    else:
        got = spmm_v2.spmm_v2(plan, x, base.clone())
        want = base + spmm_v2.spmm_v2_plain(plan, x)
    torch.cuda.synchronize()
    assert spmm_v2.LAUNCHES == before + 1
    assert_near_plain(got, want)
