"""The port's measuring entry points (``isplib_tpu_torch.bench``,
``bench_fused``) and their cost model (``utils.roofline``) on the CPU:
the headline SpMM and the FusedMM pipelines against the JAX package on the
same arrays, plan costs against counts written out by hand, and the bench's
command line (one stdout line, exit 2 without a card)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isplib_tpu
from isplib_tpu.ops.fused import fused_mm as jax_fused_mm
from isplib_tpu.ops.semiring import FusedOp as JFusedOp
from isplib_tpu.ops.semiring import Reduce as JReduce
from isplib_tpu.ops.semiring import ReduceOp as JReduceOp
from isplib_tpu.ops.semiring import ScaleOp as JScaleOp
from isplib_tpu.ops.semiring import VectorOp as JVectorOp
from isplib_tpu_torch import bench, bench_fused, spmm
from isplib_tpu_torch.ops.fused import fused_mm
from isplib_tpu_torch.sparse.tiling import (build_plan_v1_arrays,
                                            build_tiling_from_numpy)
from isplib_tpu_torch.sparse.tiling_v2 import build_plan_v2_arrays
from isplib_tpu_torch.sparse.tiling_v5 import build_hybrid_plan
from isplib_tpu_torch.utils import roofline
from isplib_tpu_torch.utils.timing import chain_time, chain_times

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--scale", "0.002"]


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Fresh graph, plan and tune caches for the port."""
    monkeypatch.setenv("ISPLIB_TPU_TORCH_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("ISPLIB_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "tune.json"))
    return tmp_path


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX system's bench.py (it sets its JAX caches only in main)."""
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (a) the stage-1 product against the JAX package on the same arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,tol", [([], 2e-2), (["--version", "2"], 1e-5)],
                         ids=["v5", "v2"])
def test_headline_spmm_matches_jax(caches, jax_bench, extra, tol):
    args = bench.parse_args(SMALL + extra)
    _, arrays, graph = bench.headline_graph(args, "cpu")
    tiled = build_tiling_from_numpy(graph, arrays, k=args.k,
                                    build_backward=False,
                                    **bench.plan_config(args))
    x = bench.headline_x(graph, args.k)
    assert x.dtype == torch.float32 and x.shape == (graph.num_cols, 32)
    got = spmm(tiled, x).numpy()
    want = np.asarray(isplib_tpu.spmm(jax_bench._to_graph(arrays),
                                      jnp.asarray(x.numpy()),
                                      backend="xla"))
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# (b) plan costs against hand counts, and the peaks table
# ---------------------------------------------------------------------------

K = 32
FP32, BF16 = roofline.FP32_FLOPS, roofline.BF16_TENSOR_FLOPS


def _full_block_plus_three():
    """A 256×256 graph: block (0, 0) full (16,384 edges) and three edges
    in block (1, 1) (rows 130, 131, 200), row-sorted."""
    r, c = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    row = np.concatenate([r.ravel(), [130, 131, 200]])
    col = np.concatenate([c.ravel(), [140, 250, 129]])
    return row, col, np.ones(row.shape[0], np.float32)


def _six_edges():
    """A 600×600 graph: five edges in columns < 512 and one in column 550,
    all in rows < 8."""
    row = np.array([0, 1, 2, 3, 5, 7])
    col = np.array([10, 20, 30, 40, 50, 550])
    return row, col, np.arange(1, 7, dtype=np.float32)


def test_plan_cost_v5_by_hand():
    plan = build_hybrid_plan(*_full_block_plus_three(), 256, 256, "cpu",
                             dense_threshold=64)
    assert (plan.nb, plan.sparse_edges, plan.nseg) == (1, 3, 3)
    # K2: one bf16 block, 2 + 1 block-row pointers and 1 block column;
    # K1: 8 B an edge, 257 row pointers, 2·3 + 1 segment words;
    # x (256 rows) and the output (256 rows) once
    nbytes = (16384 * 2 + 4 * 4) + (3 * 8 + 257 * 4 + 7 * 4) + 512 * K * 4
    assert nbytes == 99400
    got = roofline.plan_cost(plan, K)
    assert got == (nbytes, max(2 * 16384 * K / BF16, 2 * 3 * K / FP32))
    assert roofline.cost_bound_ms(*got) == (nbytes / 3.35e12 * 1e3, "bytes")


def test_plan_cost_v2_and_v1_by_hand():
    row, col, val = _six_edges()
    v2 = build_plan_v2_arrays(row, col, val, 600, 600, rb=256, ct=512,
                              eb=512, k=K, device="cpu")
    # 3 planes of 4 B a real edge; cells (0, tile 0) and (0, tile 1) read
    # 512 + 88 x rows; 600 output rows
    assert roofline.plan_cost(v2, K) == (6 * 12 + 600 * K * 4 + 600 * K * 4,
                                         2 * 6 * K / FP32)
    # K7's output is the values and the winning ids: 8 B an entry
    assert roofline.v2_cost(v2, K, out_bytes_per=8)[0] == (
        6 * 12 + 600 * K * 4 + 600 * K * 8)
    v1 = build_plan_v1_arrays(row, col, val, 600, 600, rb=256, ct=512,
                              eb=512, device="cpu")
    assert v1.nc == 4  # two buckets of row block 0, a pad chunk each for 1, 2
    # 12 B a real edge, 8 B a chunk, 3 + 1 chunk starts, 6 x rows, 600
    # output rows
    assert roofline.plan_cost(v1, K) == (
        6 * 12 + 4 * 8 + 4 * 4 + 6 * K * 4 + 600 * K * 4, 2 * 6 * K / FP32)


def test_plan_bound_of_a_tiled_graph_is_its_forward_plan_cost(caches):
    args = bench.parse_args(SMALL)
    _, arrays, graph = bench.headline_graph(args, "cpu")
    tiled = build_tiling_from_numpy(graph, arrays, k=K, build_backward=False)
    nbytes, op_s = roofline.plan_cost(tiled.fwd, K)
    assert roofline.plan_bound_edges_per_s(tiled, K, "cpu") == (
        graph.nnz / max(nbytes / 3.35e12, op_s))
    assert roofline.gather_roofline_edges_per_s(K) == 3.35e12 / (K * 4 + 8)


def test_device_peaks_by_card_name(monkeypatch):
    assert roofline.device_peaks("cpu") == roofline.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert roofline.device_peaks("cuda") == roofline.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="NVIDIA H100 PCIe"):
        roofline.device_peaks("cuda")


def test_chain_times_keeps_every_chain():
    calls = []

    def f(x):
        calls.append(1)
        return x + 1

    x = torch.zeros(3)
    times = chain_times(f, x, iters=4, repeats=5)
    assert len(times) == 5 and all(t > 0 for t in times)
    assert len(calls) == 1 + 4 * 5
    assert chain_time(f, x, iters=2, repeats=2) > 0


# ---------------------------------------------------------------------------
# (c) the bench on the command line
# ---------------------------------------------------------------------------

def _bench_cli(caches, *args):
    env = dict(os.environ, ISPLIB_TPU_TORCH_CACHE_DIR=str(caches / "plans"),
               ISPLIB_TPU_TORCH_TUNE_CACHE=str(caches / "tune.json"))
    return subprocess.run([sys.executable, "-m", "isplib_tpu_torch.bench",
                           *args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=240)


def test_bench_prints_one_line_on_the_cpu(caches):
    p = _bench_cli(caches, *SMALL, "--iters", "2", "--epochs", "3")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1, p.stdout
    line = json.loads(lines[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "spmm_sum_edges_per_s_k32_reddit"
    assert line["unit"] == "edges/s/chip"
    assert line["value"] > 0 and 0 < line["vs_baseline"] <= 1
    stages = json.loads(next(s for s in p.stderr.splitlines()
                             if s.startswith("stages: "))[len("stages: "):])
    assert {"headline", "fwd_bwd", "max", "densrep", "shard",
            "gcn"} <= set(stages)
    assert len(stages["headline"]["chains_ms"]) == bench.HEADLINE_REPEATS
    assert stages["headline"]["ms"] == min(stages["headline"]["chains_ms"])
    # the CPU runs the kernels' plain versions: no kernel launches
    assert stages["headline"]["launches"] == {}
    assert "plan build: " in p.stderr and "GCN epoch" in p.stderr


def test_bench_exits_2_without_a_card(caches):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _bench_cli(caches, "--scale", "0.002")
    assert p.returncode == 2
    assert p.stdout == ""
    assert "--device cpu" in p.stderr


def test_bench_tune_chooses_the_headline_plan(caches):
    out = bench.run(SMALL + ["--tune", "--iters", "2", "--skip-bwd",
                             "--skip-minmax", "--skip-densrep",
                             "--skip-shard", "--skip-gcn"])
    plan = out["headline"]["plan"]
    assert plan["backend"] in ("kernels", "reference")
    assert 0 < out["line"]["vs_baseline"] <= 1
    assert set(out) == {"device", "args", "headline", "seconds", "line"}


def test_bench_rejects_a_key_its_version_lacks(caches):
    with pytest.raises(ValueError, match="plan version 5 takes"):
        bench.run(SMALL + ["--rb", "512", "--skip-densrep", "--skip-shard",
                           "--skip-gcn"])


# ---------------------------------------------------------------------------
# (d) the FusedMM pipelines against JAX's XLA path
# ---------------------------------------------------------------------------

JAX_PIPELINES = {
    "sigmoid-embed": JFusedOp(vop=JVectorOp.MUL, rop=JReduceOp.DOT,
                              sop=jax.nn.sigmoid, vsc=JScaleOp.MUL,
                              aop=JReduce.SUM),
    "tdist-force": JFusedOp(vop=JVectorOp.SUB, rop=JReduceOp.NORM2,
                            sop=lambda t: 1.0 / (1.0 + t),
                            vsc=JScaleOp.MUL, aop=JReduce.SUM),
}


def test_bench_fused_matches_jax(caches, capsys, jax_bench):
    nodes, edges = 300, 6000
    out = bench_fused.run(nodes, edges, iters=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    for name, r in out.items():
        assert r["relerr"] <= 1e-5 and r["graderr"] <= 1e-5, (name, r)
        assert [ln.startswith(f"{name:14s}:") for ln in lines].count(True) \
            == 2
    assert sorted(out) == sorted(JAX_PIPELINES)

    arrays, _, tiled, x, y = bench_fused.inputs(nodes, edges, "cpu")
    jg = jax_bench._to_graph(arrays)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    for name, op in bench_fused.PIPELINES.items():
        jop = JAX_PIPELINES[name]
        want = np.asarray(jax_fused_mm(jg, jx, jy, jop, backend="xla"))
        got = fused_mm(tiled, x, y, op).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

        def jloss(a, b, jop=jop):
            return 0.5e-6 * jnp.sum(jax_fused_mm(jg, a, b, jop,
                                                 backend="xla") ** 2)

        xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        o = fused_mm(tiled, xg, yg, op)
        got_g = torch.autograd.grad(0.5e-6 * (o ** 2).sum(), (xg, yg))
        for a, b in zip(got_g, jax.grad(jloss, argnums=(0, 1))(jx, jy)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
