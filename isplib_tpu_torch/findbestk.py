"""The offline K sweep, the counterpart of the JAX package's
``scripts/findbestk.py`` (the reference's ``findbestk`` workflow).

    python -m isplib_tpu_torch.findbestk <dataset|path/to/graph.mtx> \\
        [--ks 16,32,64,128,256,512,1024] [--scale 0.05] [--iters 8] \\
        [--extra '[{"version": 5, "dense_threshold": 256}]'] [--device cuda]

For each K, ``tune_spmm`` times the reference path and every configuration
on the graph's device and records the winner in the tune cache (its plans
in the plan cache), so that ``auto_tile`` and ``train_node_classifier``
later take it; the table is for the reader.  ``--extra`` adds
configurations (a JSON list of ``build_tiling`` dicts) to
``tune.DEFAULT_CONFIGS``.  The graph: a ``.mtx`` file through the numpy
builder, or a dataset name (``reddit``, ``reddit-sim``, ...) as R-MAT
edges ``rmat_edges(n·scale, e·scale, seed=0)`` of its node and edge counts,
both with 4096 as the edge multiple, as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_graph(name: str, scale: float, device="cuda"):
    """``(CSRGraph, host arrays)`` of a dataset name or a ``.mtx`` path."""
    from .data.loaders import DATASET_STATS
    from .data.synthetic import rmat_edges
    from .sparse.graph import _build_arrays, graph_from_arrays

    if name.endswith(".mtx"):
        import scipy.io
        coo = scipy.io.mmread(name).tocoo()
        arrays = _build_arrays(coo.row, coo.col, coo.data.astype(np.float32),
                               int(coo.shape[0]), int(coo.shape[1]), 4096)
    else:
        base = name[:-4] if name.endswith("-sim") else name
        n, e, _, _ = DATASET_STATS[base]
        n, e = int(n * scale), int(e * scale)
        src, dst = rmat_edges(n, e, seed=0)
        arrays = _build_arrays(dst, src, np.ones(len(src), np.float32), n, n,
                               4096)
    return graph_from_arrays(arrays, device), arrays


def sweep(graph, arrays: dict, ks, iters: int = 8, configs=None,
          verbose: bool = False) -> list[tuple[int, dict]]:
    """``tune_spmm`` at each K (``configs``: the configurations to time,
    ``DEFAULT_CONFIGS`` when None); returns ``[(K, winner entry)]``."""
    from .tune.autotune import tune_spmm

    return [(k, tune_spmm(graph, arrays, k=k, configs=configs, iters=iters,
                          verbose=verbose)[0]) for k in ks]


def table(rows: list[tuple[int, dict]]) -> str:
    """The JAX script's table: K, backend, configuration, ms, Gedges/s,
    and the K with the most edges per second."""
    lines = [f"{'K':>6} {'backend':>9} {'config':>44} {'ms':>9} "
             f"{'Gedges/s':>9}"]
    for k, b in rows:
        cfg = " ".join(f"{f}={v}" for f, v in b.items()
                       if f not in ("backend", "seconds", "edges_per_s",
                                    "fill")) or "-"
        lines.append(f"{k:>6} {b['backend']:>9} {cfg:>44} "
                     f"{b['seconds'] * 1e3:>9.4f} "
                     f"{b['edges_per_s'] / 1e9:>9.3f}")
    best_k = max(rows, key=lambda r: r[1]["edges_per_s"])[0]
    lines.append(f"best K by edges/s: {best_k} "
                 f"(all winners persisted to the tune cache)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.findbestk")
    ap.add_argument("graph", help="dataset name (e.g. reddit) or .mtx path")
    ap.add_argument("--ks", default="16,32,64,128,256,512,1024",
                    help="comma-separated K sweep")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--extra", default=None,
                    help="JSON list of build_tiling dicts to time beside "
                         "DEFAULT_CONFIGS")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .tune.autotune import DEFAULT_CONFIGS

    configs = None
    if args.extra:
        configs = list(DEFAULT_CONFIGS) + list(json.loads(args.extra))
    graph, arrays = load_graph(args.graph, args.scale, args.device)
    print(f"graph: {graph.shape}, nnz={graph.nnz}", file=sys.stderr)
    rows = sweep(graph, arrays, [int(k) for k in args.ks.split(",")],
                 iters=args.iters, configs=configs)
    print(table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
