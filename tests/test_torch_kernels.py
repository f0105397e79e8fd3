"""The port's CUDA kernels and their wrappers, without JAX.

On a machine without a card the wrapper and build checks run and the
kernel tests skip.  On a card (where JAX need not be installed) run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

to hold each kernel against its plain version; ``chip_smoke.py`` does the
same at the main path's shapes.
"""

import numpy as np
import pytest
import torch

import isplib_tpu_torch as pt
from isplib_tpu_torch.kernels import (build, spmm_bsr, spmm_minmax_v4,
                                      spmm_stream)
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.sparse.tiling_v5 import SEG_EDGES


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
    assert names == ["spmm_bsr.cu", "spmm_minmax_v4.cu", "spmm_stream.cu"]


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


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 32, 41, 130, 602])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("ties", [False, True])
def test_minmax_kernel_matches_plain_version(cuda, ties, reduce, k):
    """Exact fp32 on both sides: values equal bit for bit (the winner's own
    product, so also the sign of a zero), args equal."""
    g = zero_tie_graph(cuda) if ties else hub_graph(cuda)
    plan = build_tiling(g).fwd_mm
    assert plan.nsplit > 0
    x = torch.randn(g.num_cols, k, device=cuda)
    if ties:
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
