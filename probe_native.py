#!/usr/bin/env python3
"""Time the port's two host builders of a graph and its v5 plans, step by
step: the native builder (``isplib_tpu_torch.native``, C++/OpenMP) and the
numpy build it replaces (``native.available`` patched to False).

    python3 probe_native.py                      # reddit-sim at scale 1.0
    python3 probe_native.py --scale 0.05 --device cpu

The graph is ``chip_smoke.py`` phase 11's: bench.py's reddit (232,965
nodes, 114,615,892 edges at scale 1.0) as a GCN-signal graph from R-MAT's
native stream.  Steps, each on the host clock (the v5 builds end in a
device synchronise): R-MAT (the native stream and the numpy stream, two
graphs of one law), ``_build_arrays`` (the CSR and CSC sorts), and
``build_hybrid_plan`` of A and of Aᵀ on ``--device`` at the threshold
``auto_tile`` takes, both builds on the graph's edges in one random order.
Then checks that the two builds' graph arrays are equal and their v5 plans
too (the dense blocks bit for bit on the host; on a card the numpy build's
``index_add_`` sums duplicates in the order its atomics land, so the
blocks that differ are counted).  Prints one JSON line of the seconds last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REAL, E_REAL, FEATURES, CLASSES = 232_965, 114_615_892, 602, 41
SEED = zlib.crc32(b"reddit") & 0x7FFFFFFF


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def plan_diff(a, b, path="plan") -> list[str]:
    """Fields of two HybridPlans that differ (bf16 compared by bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        if a.shape != b.shape:
            return [f"{path}: shape {tuple(a.shape)} vs {tuple(b.shape)}"]
        n = int((a != b).sum())
        return [f"{path}: {n} of {a.numel()} entries"] if n else []
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a)
                for d in plan_diff(getattr(a, f.name), getattr(b, f.name),
                                   f"{path}.{f.name}")]
    return [] if a == b else [f"{path}: {a} vs {b}"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import native
    from isplib_tpu_torch.data.synthetic import gen_gcnsig_graph, rmat_edges
    from isplib_tpu_torch.device import resolve_device
    from isplib_tpu_torch.sparse import graph as pgraph
    from isplib_tpu_torch.sparse.tiling_v5 import build_hybrid_plan

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"card: {card}")
    n, e = int(N_REAL * args.scale), int(E_REAL * args.scale)
    log(f"host: {os.cpu_count()} cores, torch threads "
        f"{torch.get_num_threads()}; graph {n} nodes, {e} edges; native "
        f"library {native.lib_path()} (built: {native.available()})")
    secs = {}

    # R-MAT's two streams (80% of the edges, as gen_gcnsig_graph draws)
    for stream in ("native", "numpy"):
        _, secs[f"rmat_{stream}"] = timed(lambda: rmat_edges(
            n, int(e * 0.8), SEED, native_stream=stream == "native"), dev)
        log(f"R-MAT, {stream} stream: {secs[f'rmat_{stream}']:.3f}s")

    arrays = gen_gcnsig_graph(n, e, CLASSES, FEATURES, SEED,
                              native_stream=True)
    nnz = arrays["nnz"]
    occ = nnz / (-(-n // 128)) ** 2
    thr = 64 if occ >= 200 else 128   # auto_tile's occupancy rule
    # the graph's COO in a random order, as R-MAT draws it
    perm = np.random.default_rng(0).permutation(nnz)
    src, dst, val = (arrays["col"][:nnz][perm], arrays["row"][:nnz][perm],
                     arrays["value"][:nnz][perm])
    del arrays, perm
    built, plans = {}, {}
    for kind in ("native", "numpy"):
        with_native = kind == "native"
        saved = native.available
        if not with_native:
            native.available = lambda: False
        try:
            built[kind], secs[f"build_arrays_{kind}"] = timed(
                lambda: pgraph._build_arrays(dst, src, val, n, n, 4096), dev)
            a = built[kind]
            plans[kind] = []
            for label, r, c, v in (("A", "row", "col", "value"),
                                   ("AT", "csc_row", "csc_col",
                                    "csc_value")):
                p, secs[f"v5_{label}_{kind}"] = timed(
                    lambda: build_hybrid_plan(a[r][:nnz], a[c][:nnz],
                                              a[v][:nnz], n, n, dev,
                                              dense_threshold=thr), dev)
                plans[kind].append(p)
        finally:
            native.available = saved
        log(f"{kind} build: _build_arrays {secs[f'build_arrays_{kind}']:.3f}"
            f"s, v5 of A {secs[f'v5_A_{kind}']:.3f}s, of Aᵀ "
            f"{secs[f'v5_AT_{kind}']:.3f}s (threshold asked {thr}, "
            f"applied {plans[kind][0].dense_threshold} / "
            f"{plans[kind][1].dense_threshold})")

    bad = [f for f in pgraph._ARRAY_FIELDS
           if not np.array_equal(built["native"][f], built["numpy"][f])]
    log(f"_build_arrays native vs numpy: "
        f"{'equal' if not bad else 'DIFFER in ' + ', '.join(bad)}")
    diffs = [d for pn, pp in zip(plans["native"], plans["numpy"])
             for d in plan_diff(pn, pp)]
    log("v5 plans native vs numpy: "
        + ("equal" if not diffs else "differ in " + "; ".join(diffs)))
    print(json.dumps({"nodes": n, "edges": nnz, "seconds": secs,
                      "arrays_equal": not bad, "plan_diffs": diffs}),
          flush=True)
    return 1 if bad or any("blocks" not in d for d in diffs) else 0


if __name__ == "__main__":
    sys.exit(main())
