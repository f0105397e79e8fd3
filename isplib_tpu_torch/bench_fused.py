"""The FusedMM pipelines' bench, the counterpart of the JAX system's
``scripts/bench_fused.py``:

    python -m isplib_tpu_torch.bench_fused [--iters 30]

On ``bench.py``'s R-MAT reddit stand-in (``gen_rmat_graph(11648, 5730794,
crc32("reddit"), 4096)``), tiled at plan version 4 as the JAX script asks,
for each of the two SOP pipelines (the sigmoid embedding kernel, ``MUL``,
``DOT``, sigmoid; the t-distribution force model, ``SUB``, ``NORM2``,
``1 / (1 + t)``): ``fused_mm`` through the kernels (K5 forward, K6 for
the gradients) against the plain path (``backend="reference"``, the
counterpart of JAX's ``backend="xla"``): the relative error against the
plain path evaluated in float64 (the fp32 plain path's own error is kept
beside it) and both chain times, then the same for forward + backward of
``0.5e-6·Σ fused_mm(x, y)²`` with respect to (x, y).  Prints two lines a
pipeline to stdout, as the JAX script does; a last ``stages: {...}`` line
on stderr holds the numbers with each part's kernel launches.  Without a
card it exits 2 (``run`` takes ``device="cpu"``).
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np
import torch

from .ops.semiring import (FusedOp, Reduce, ReduceOp, ScalarOp, ScaleOp,
                           VectorOp)

__all__ = ["PIPELINES", "inputs", "run", "main"]

NODES, EDGES, K = 11_648, 5_730_794, 32   # the JAX script's sizes

PIPELINES = {
    "sigmoid-embed": FusedOp(vop=VectorOp.MUL, rop=ReduceOp.DOT,
                             sop=ScalarOp.SIGMOID, vsc=ScaleOp.MUL,
                             aop=Reduce.SUM),
    "tdist-force": FusedOp(vop=VectorOp.SUB, rop=ReduceOp.NORM2,
                           sop=ScalarOp.TDIST, vsc=ScaleOp.MUL,
                           aop=Reduce.SUM),
}


def inputs(nodes: int, edges: int, device: str | torch.device = "cuda"):
    """``(arrays, graph, tiled, x, y)``: the R-MAT graph of ``nodes`` and
    ``edges`` from the seed ``crc32("reddit")`` (kept by ``bench``'s graph
    cache), its version-4 tiling with the transpose plan, and x, y (nodes ×
    32) from ``default_rng(0)``."""
    from .bench import load_or_gen
    from .data.synthetic import gen_rmat_graph
    from .sparse.graph import graph_from_arrays
    from .sparse.tiling import build_tiling_from_numpy

    arrays = load_or_gen(f"reddit_rmat_n{nodes}_e{edges}_m4096",
                         lambda: gen_rmat_graph(
                             nodes, edges,
                             zlib.crc32(b"reddit") & 0x7FFFFFFF, 4096))
    graph = graph_from_arrays(arrays, device)
    tiled = build_tiling_from_numpy(graph, arrays, version=4, k=K,
                                    build_backward=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(nodes, K)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(nodes, K)).astype(np.float32))
    return arrays, graph, tiled, x.to(graph.device), y.to(graph.device)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def run(nodes: int = NODES, edges: int = EDGES, iters: int = 30,
        device: str | torch.device = "cuda") -> dict:
    """Both pipelines' numbers; prints their lines to stdout."""
    from .bench import counted
    from .ops.fused import fused_mm
    from .utils.timing import chain_time

    _, g, tiled, x, y = inputs(nodes, edges, device)
    nnz = g.nnz
    out = {}
    for name, op in PIPELINES.items():
        def fwd(graph, backend, op=op):
            return lambda x_: fused_mm(graph, x_, y, op, backend) * 1e-3

        def grads(graph, backend, x_, y_=y, op=op):
            x_ = x_.detach().requires_grad_(True)
            y_ = y_.detach().requires_grad_(True)
            o = fused_mm(graph, x_, y_, op, backend)
            return torch.autograd.grad(0.5e-6 * (o ** 2).sum(), (x_, y_))

        # the errors against the plain path evaluated in float64: the fp32
        # plain path sums a hub row's edges by atomics in a run-to-run
        # order, its own error is kept beside the kernels'
        exact = fused_mm(g, x.double(), y.double(), op, "reference")
        err = _rel(fused_mm(tiled, x, y, op), exact)
        plain_err = _rel(fused_mm(g, x, y, op, "reference"), exact)
        del exact
        tx = chain_time(fwd(g, "reference"), x, iters)
        tp, l_fwd = counted(lambda: chain_time(fwd(tiled, "auto"), x,
                                               iters))
        print(f"{name:14s}: plain {tx * 1e3:8.3f} ms ({nnz / tx / 1e9:6.3f}"
              f" Ge/s) | kernels {tp * 1e3:8.3f} ms ({nnz / tp / 1e9:6.3f} "
              f"Ge/s) | {tx / tp:4.1f}x relerr={err:.1e}", flush=True)

        exact = grads(g, "reference", x.double(), y.double())
        gerr = max(_rel(a, b) for a, b in zip(grads(tiled, "auto", x),
                                              exact))
        plain_gerr = max(_rel(a, b) for a, b in zip(grads(g, "reference", x),
                                                    exact))
        del exact
        bwd_iters = max(4, iters // 2)
        tbx = chain_time(lambda x_: grads(g, "reference", x_)[0], x,
                         bwd_iters)
        tbp, l_bwd = counted(lambda: chain_time(
            lambda x_: grads(tiled, "auto", x_)[0], x, bwd_iters))
        print(f"{name:14s}: fwd+bwd plain {tbx * 1e3:8.3f} ms | kernels "
              f"{tbp * 1e3:8.3f} ms | {tbx / tbp:4.1f}x graderr={gerr:.1e}",
              flush=True)
        out[name] = dict(plain_ms=tx * 1e3, kernels_ms=tp * 1e3, relerr=err,
                         plain_relerr=plain_err, fwd_bwd_plain_ms=tbx * 1e3,
                         fwd_bwd_kernels_ms=tbp * 1e3, graderr=gerr,
                         plain_graderr=plain_gerr, launches=l_fwd,
                         launches_fwd_bwd=l_bwd)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.bench_fused")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("isplib_tpu_torch.bench_fused: torch.cuda.is_available() is "
              "false; this bench needs a CUDA card", file=sys.stderr)
        return 2
    out = run(iters=args.iters)
    print("stages: " + json.dumps(out), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
