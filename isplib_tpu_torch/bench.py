"""The port's benchmark driver, the counterpart of the JAX system's
``bench.py``:

    python -m isplib_tpu_torch.bench [--scale 0.05] [--k 32] [--device cuda]

Prints exactly one JSON line to stdout, last:

    {"metric": "spmm_sum_edges_per_s_k{K}_{dataset}", "value": N,
     "unit": "edges/s/chip", "vs_baseline": N}

``value`` is the sum-SpMM's edges a second on the headline graph, from the
fastest of six chains of calls on the card's clock (the median and the
spread of the six are logged beside it).  ``vs_baseline`` is ``value``
over the plan-aware bound of the plan that ran (``utils.roofline``): at
most 1 by construction.  Everything else goes to stderr, one line a stage,
and a last ``stages: {...}`` line holds every stage's numbers (``run``'s
dict).

Stages (the JAX lines they port):

1. the headline (``bench.py:504-545``): an R-MAT graph of the dataset's
   nodes and edges times ``--scale`` from the seed ``crc32(dataset)``,
   tiled by ``build_tiling_from_numpy`` (or ``tune_spmm`` under
   ``--tune``), ``spmm(tiled, x) * 1e-3`` chained;
2. forward + backward (``:547-551``): ``grad_x`` of ``0.5e-6·Σ spmm(x)²``;
2b. max through K3 (``:553-571``) on the same tiling;
3. density-rep (``:573-609``): the full graph's edges per 128×128 block at
   the same edge count, through v5 (K2 + K1) and v2 (K8), each against its
   own bound;
3b. the shard overhead (``:348-401``): the one-shard partition through
   ``spmm_sharded`` against the plain v5 SpMM;
4. GCN (``:611-642``): the GCN-signal graph, ``GCN(hidden=32)`` for
   ``--epochs`` epochs, its epoch time and accuracies.

Left out, as TPU workarounds or TPU models: the headline re-measure
(``:644-678``), the VPU-gather floor (``:199-224``) and the ICI scaling
model (``:403-419``).  JAX's ``--S`` has no counterpart, nor do its
occupancy defaults of ``rb`` and ``g``: ``--rb``, ``--ct``, ``--eb``,
``--g`` and ``--gd`` go to the plan build only where given, and a key the
version does not take raises.  Without a card the bench exits 2 unless
``--device cpu`` asks for the CPU; it never falls back.  Generated graphs
are kept as ``bench_<tag>.npz`` in ``$ISPLIB_TPU_TORCH_CACHE_DIR``
(default ``~/.cache/isplib_tpu_torch``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import sys
import time
import zlib

import numpy as np
import torch

from .kernels import (fused, fused_bwd, sddmm, spmm_bsr, spmm_bsr_v3,
                      spmm_minmax, spmm_minmax_v4, spmm_rowblock, spmm_stream,
                      spmm_v2)

__all__ = ["run", "main", "parse_args", "load_or_gen", "headline_graph",
           "headline_x", "plan_config", "counted"]

KERNELS = {"spmm_bsr": spmm_bsr, "spmm_stream": spmm_stream,
           "spmm_minmax_v4": spmm_minmax_v4, "sddmm": sddmm,
           "fused": fused, "fused_bwd": fused_bwd, "spmm_v2": spmm_v2,
           "spmm_minmax": spmm_minmax, "spmm_bsr_v3": spmm_bsr_v3,
           "spmm_rowblock": spmm_rowblock}
HEADLINE_REPEATS = 6   # chains of the headline; value is the fastest
GCN_OK_ACC = 0.7       # bench.py's train-accuracy check
SHARD_OK_PCT, SHARD_OK_MS = 20.0, 0.25   # bench.py's shard-overhead rule


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.bench")
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "reference"))
    ap.add_argument("--edge-multiple", type=int, default=4096)
    ap.add_argument("--skip-gcn", action="store_true")
    ap.add_argument("--skip-densrep", action="store_true")
    ap.add_argument("--skip-bwd", action="store_true")
    ap.add_argument("--skip-shard", action="store_true")
    ap.add_argument("--skip-minmax", action="store_true")
    ap.add_argument("--version", type=int, default=5,
                    help="plan version: 5 dense blocks + residual edges, 4 "
                         "residual edges only, 3 celled blocks + v2, 2 v2 "
                         "cells, 1 row blocks")
    ap.add_argument("--dense-threshold", type=int, default=64,
                    help="edges a 128x128 block needs to be dense "
                         "(versions 5 and 3)")
    for key in ("rb", "ct", "eb", "g", "gd"):
        ap.add_argument(f"--{key}", type=int, default=None,
                        help="a plan key, passed only where given")
    ap.add_argument("--tune", action="store_true",
                    help="tune_spmm chooses the headline plan")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_or_gen(tag: str, gen_fn) -> dict:
    """The graph ``gen_fn()`` (a dict of numpy arrays), kept as
    ``bench_<tag>.npz`` in the port's cache directory."""
    from .sparse.plan_cache import default_cache_dir
    path = os.path.join(default_cache_dir(), f"bench_{tag}.npz")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        data = gen_fn()
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **data)
        os.replace(tmp, path)
        log(f"generated {tag} in {time.perf_counter() - t0:.1f}s")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def headline_x(graph, k: int) -> torch.Tensor:
    """``bench.py``'s x: ``default_rng(0).normal`` of (C, K), float32."""
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=(graph.num_cols, k)).astype(np.float32)).to(graph.device)


def counted(fn):
    """``(fn(), launches)``: every kernel's count set to 0 just before
    ``fn`` and read just after; only the kernels that launched."""
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
    out = fn()
    return out, {n: m.LAUNCHES for n, m in KERNELS.items() if m.LAUNCHES}


def headline_graph(args, device) -> tuple:
    """Stage 1's graph: ``(tag, host arrays, CSRGraph on device)``, the
    R-MAT graph of the dataset's nodes and edges times ``--scale`` from the
    seed ``crc32(dataset)``."""
    from .data import DATASET_STATS
    from .data.synthetic import gen_rmat_graph
    from .sparse.graph import graph_from_arrays

    n_real, e_real, _, _ = DATASET_STATS[args.dataset]
    n, e = int(n_real * args.scale), int(e_real * args.scale)
    seed = zlib.crc32(args.dataset.encode()) & 0x7FFFFFFF
    tag = f"{args.dataset}_s{args.scale}_m{args.edge_multiple}"
    arrays = load_or_gen(tag, lambda: gen_rmat_graph(
        n, e, seed, args.edge_multiple))
    return tag, arrays, graph_from_arrays(arrays, device)


def plan_config(args) -> dict:
    """The headline's ``build_tiling`` keys: the version, the dense
    threshold for versions 5 and 3, and each plan key given."""
    cfg = dict(version=args.version)
    if args.version in (5, 3):
        cfg["dense_threshold"] = args.dense_threshold
    cfg.update({key: getattr(args, key) for key in ("rb", "ct", "eb", "g",
                                                    "gd")
                if getattr(args, key) is not None})
    return cfg


def _peak_gib(dev) -> float | None:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _spmm_times(tiled, x, iters, backend, repeats=3, reduce="sum",
                with_grad=False) -> list[float]:
    """Seconds per call of each chain (``bench.py``'s ``bench_spmm``)."""
    from .ops.spmm import spmm
    from .utils.timing import chain_times

    if with_grad:
        def f(x_):
            x_ = x_.detach().requires_grad_(True)
            out = spmm(tiled, x_, reduce, backend=backend)
            return torch.autograd.grad(0.5e-6 * (out ** 2).sum(), x_)[0]
    else:
        def f(x_):
            return spmm(tiled, x_, reduce, backend=backend) * 1e-3
    return chain_times(f, x, iters, repeats)


def shard_overhead(np_arrays: dict, k: int, iters: int, dev) -> dict:
    """The one-shard partition through ``spmm_sharded`` on a ``LocalMesh``
    against the plain v5 SpMM of the same edges (``bench.py:348-401``)."""
    from .dist import LocalMesh, partition_rows, spmm_sharded
    from .kernels.spmm_hybrid import spmm_hybrid
    from .sparse.tiling_v5 import build_hybrid_plan
    from .utils.timing import chain_time

    nnz, n = int(np_arrays["nnz"]), int(np_arrays["num_rows"])
    row = np_arrays["row"][:nnz].astype(np.int64)
    col = np_arrays["col"][:nnz].astype(np.int64)
    val = np_arrays["value"][:nnz].astype(np.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, k)).astype(np.float32)).to(dev)

    plain = build_hybrid_plan(row, col, val, n, n, dev, dense_threshold=64)
    t_plain, l_plain = counted(lambda: chain_time(
        lambda x_: spmm_hybrid(plain, x_)[:n] * 1e-3, x, iters))
    del plain
    sg = partition_rows(row, col, val, n, num_shards=1,
                        tiling=dict(version=5, minmax=False), device=dev)
    mesh = LocalMesh()
    t_shard, l_shard = counted(lambda: chain_time(
        lambda x_: spmm_sharded(sg, x_, mesh=mesh) * 1e-3, x, iters))
    del sg
    pct = (t_shard - t_plain) / t_plain * 100
    abs_ms = (t_shard - t_plain) * 1e3
    return dict(plain_ms=t_plain * 1e3, sharded_ms=t_shard * 1e3,
                overhead_pct=pct, overhead_ms=abs_ms,
                ok=bool(pct < SHARD_OK_PCT or abs_ms < SHARD_OK_MS),
                launches_plain=l_plain, launches_sharded=l_shard)


def run(argv=None) -> dict:
    """Every stage's numbers; ``["line"]`` is the one JSON line."""
    from .data import DATASET_STATS, NodeDataset
    from .data.synthetic import gen_gcnsig_graph, gen_rmat_graph
    from .device import resolve_device
    from .nn import GCN
    from .sparse.graph import graph_from_arrays
    from .sparse.tiling import TiledGraph, build_tiling_from_numpy
    from .train import train_node_classifier
    from .utils.roofline import (device_peaks, gather_roofline_edges_per_s,
                                 plan_bound_edges_per_s)

    args = parse_args(argv)
    dev = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    peaks = device_peaks(dev)
    t_start = time.perf_counter()

    def stamp() -> str:
        return f"[{time.perf_counter() - t_start:.0f}s]"

    log(f"device: {dev} ({kind}); torch {torch.__version__}")
    base = args.dataset
    n_real, e_real, _, ncls = DATASET_STATS[base]
    n, e = int(n_real * args.scale), int(e_real * args.scale)
    seed = zlib.crc32(base.encode()) & 0x7FFFFFFF
    k = args.k
    cfg = plan_config(args)
    out = dict(device=dict(type=dev.type, kind=kind), args=vars(args))

    # ---- stage 1: the headline SpMM -----------------------------------
    _reset_peak(dev)
    tag, np_arrays, graph = headline_graph(args, dev)
    nnz = graph.nnz
    log(f"graph: {graph.shape}, nnz={nnz} {stamp()}")
    t0 = time.perf_counter()
    if args.tune:
        from .tune import tune_spmm
        best, tiled = tune_spmm(graph, np_arrays, k=k)
        plan = best
        if tiled is None:
            tiled = graph
    else:
        tiled = build_tiling_from_numpy(graph, np_arrays, k=k,
                                        build_backward=not args.skip_bwd,
                                        **cfg)
        plan = cfg
    build_s = time.perf_counter() - t0
    if isinstance(tiled, TiledGraph):
        f = tiled.fwd
        log(f"plan {plan} ready in {build_s:.1f}s: fill={f.fill:.2f}"
            + (f", dense_e={f.dense_edges}, sparse_e={f.sparse_edges}"
               if hasattr(f, "dense_edges") else "")
            + (f", threshold after the block cap {f.dense_threshold}"
               if hasattr(f, "dense_threshold") else ""))
    x = headline_x(graph, k)
    times, launches = counted(lambda: _spmm_times(
        tiled, x, args.iters, args.backend, repeats=HEADLINE_REPEATS))
    t_spmm, t_med = min(times), float(np.median(times))
    edges_per_s = nnz / t_spmm
    groof = gather_roofline_edges_per_s(k, peaks.hbm_bytes_per_s)
    bound = (plan_bound_edges_per_s(tiled, k, dev)
             if isinstance(tiled, TiledGraph) else groof)
    log(f"SpMM(sum, K={k}): {t_spmm * 1e3:.4f} ms (median "
        f"{t_med * 1e3:.4f}, max {max(times) * 1e3:.4f} of "
        f"{len(times)} chains) → {edges_per_s / 1e9:.3f} Ge/s = "
        f"{100 * edges_per_s / bound:.1f}% of plan-aware bound "
        f"{bound / 1e9:.2f} Ge/s (gather-model roofline "
        f"{groof / 1e9:.2f} Ge/s); launches {launches} {stamp()}")
    out["headline"] = dict(
        graph=tag, nodes=graph.num_rows, edges=nnz, plan=plan,
        build_s=build_s, ms=t_spmm * 1e3, median_ms=t_med * 1e3,
        chains_ms=[t * 1e3 for t in times], edges_per_s=edges_per_s,
        bound_edges_per_s=bound, vs_baseline=edges_per_s / bound,
        gather_roofline_edges_per_s=groof, launches=launches)

    # ---- stage 2: forward + backward ----------------------------------
    if not args.skip_bwd:
        times, launches = counted(lambda: _spmm_times(
            tiled, x, max(2, args.iters // 2), args.backend,
            with_grad=True))
        log(f"SpMM fwd+bwd (x-dependent loss): {min(times) * 1e3:.4f} ms "
            f"(median {np.median(times) * 1e3:.4f}); launches {launches} "
            f"{stamp()}")
        out["fwd_bwd"] = dict(ms=min(times) * 1e3,
                              median_ms=float(np.median(times)) * 1e3,
                              launches=launches)

    # ---- stage 2b: max through K3 (every TiledGraph has fwd_mm) --------
    if not args.skip_minmax:
        times, launches = counted(lambda: _spmm_times(
            tiled, x, args.iters, args.backend, reduce="max"))
        log(f"SpMM(max, K={k}, in-kernel args): {min(times) * 1e3:.4f} ms "
            f"→ {nnz / min(times) / 1e9:.3f} Ge/s; launches {launches} "
            f"{stamp()}")
        out["max"] = dict(ms=min(times) * 1e3,
                          edges_per_s=nnz / min(times), launches=launches)
    out["headline"]["peak_gib"] = _peak_gib(dev)
    del x

    # ---- stage 3: the density-representative graph --------------------
    if not args.skip_densrep:
        _reset_peak(dev)
        occ_real = e_real / (n_real / 128.0) ** 2
        n_dens = int(128 * np.sqrt(e / occ_real))
        dtag = f"{base}_dens{n_dens}_e{e}_m{args.edge_multiple}"
        dnp = load_or_gen(dtag, lambda: gen_rmat_graph(
            n_dens, e, seed + 7, args.edge_multiple))
        dgraph = graph_from_arrays(dnp, dev)
        dx = headline_x(dgraph, k)
        log(f"density-rep graph: {dgraph.shape}, nnz={dgraph.nnz} "
            f"(~{occ_real:.0f} edges per 128x128 block, matching full "
            f"{base})")
        out["densrep"] = dict(graph=dtag, nodes=dgraph.num_rows,
                              edges=dgraph.nnz)
        for name, dcfg in (("v5", dict(version=5, dense_threshold=128)),
                           ("v2", dict(version=2, rb=512, ct=1024, eb=512,
                                       gd=8))):
            t0 = time.perf_counter()
            dt_g = build_tiling_from_numpy(dgraph, dnp, k=k,
                                           build_backward=False, **dcfg)
            d_build = time.perf_counter() - t0
            times, launches = counted(lambda: _spmm_times(
                dt_g, dx, args.iters, args.backend))
            dt = min(times)
            dbound = plan_bound_edges_per_s(dt_g, k, dev)
            extra = (f" dense_e={dt_g.fwd.dense_edges}/{dgraph.nnz}"
                     if name == "v5" else "")
            log(f"density-rep {name}: {dt * 1e3:.4f} ms → "
                f"{dgraph.nnz / dt / 1e9:.3f} Ge/s = "
                f"{100 * dgraph.nnz / dt / dbound:.1f}% of plan bound "
                f"{dbound / 1e9:.2f} Ge/s (fill={dt_g.fwd.fill:.2f}{extra})"
                f" [plan {d_build:.1f}s]; launches {launches} {stamp()}")
            out["densrep"][name] = dict(
                plan=dcfg, build_s=d_build, ms=dt * 1e3,
                edges_per_s=dgraph.nnz / dt, bound_edges_per_s=dbound,
                of_bound=dgraph.nnz / dt / dbound, fill=dt_g.fwd.fill,
                launches=launches)
            del dt_g
        del dgraph, dnp, dx
        out["densrep"]["peak_gib"] = _peak_gib(dev)

    # ---- stage 3b: the shard overhead on one shard --------------------
    if not args.skip_shard:
        _reset_peak(dev)
        r = shard_overhead(np_arrays, k, args.iters, dev)
        log(f"shard overhead mesh(1): plain {r['plain_ms']:.4f} ms vs "
            f"sharded {r['sharded_ms']:.4f} ms → {r['overhead_pct']:+.1f}% "
            f"({r['overhead_ms']:+.4f} ms fixed; "
            f"{'OK' if r['ok'] else 'HIGH'}); launches "
            f"{r['launches_sharded']} {stamp()}")
        r["peak_gib"] = _peak_gib(dev)
        out["shard"] = r

    line = dict(metric=f"spmm_sum_edges_per_s_k{k}_{base}",
                value=edges_per_s, unit="edges/s/chip",
                vs_baseline=edges_per_s / bound)

    # ---- stage 4: GCN on a graph with a learnable signal --------------
    if not args.skip_gcn:
        # stage 1's tensors go first: at scale 1.0 two resident graphs of
        # 115M edges with their plans crowd the card
        del graph, tiled, np_arrays
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _reset_peak(dev)
        gtag = f"{base}_gcnsig_s{args.scale}_m{args.edge_multiple}"
        gnp = load_or_gen(gtag, lambda: gen_gcnsig_graph(
            n, e, ncls, max(k, 32), seed, args.edge_multiple))
        aux = {k2: gnp.pop(k2) for k2 in ("x", "y", "train_mask",
                                         "test_mask")}
        ggraph = graph_from_arrays(gnp, dev)
        gt = build_tiling_from_numpy(ggraph, gnp, k=k, **cfg)
        ds = NodeDataset(name="bench", graph=gt,
                         x=aux["x"][:, :k].astype(np.float32), y=aux["y"],
                         train_mask=aux["train_mask"],
                         val_mask=aux["train_mask"],
                         test_mask=aux["test_mask"], num_classes=ncls)
        model = GCN(k, hidden=32, num_classes=ncls, device=dev, seed=0)
        res, launches = counted(lambda: train_node_classifier(
            model, ds, epochs=args.epochs, device=dev,
            tile=args.backend != "reference"))
        ok = res.train_acc > GCN_OK_ACC
        peak = _peak_gib(dev)
        log(f"GCN epoch: {res.train_time_avg * 1e3:.4f} ms (train acc "
            f"{res.train_acc:.3f} [{'OK' if ok else 'LOW'}], test acc "
            f"{res.test_acc:.3f}, {args.epochs} epochs); peak device "
            f"memory {peak if peak is None else f'{peak:.2f} GiB'}; "
            f"launches {launches} {stamp()}")
        out["gcn"] = dict(graph=gtag, epoch_ms=res.train_time_avg * 1e3,
                          epoch_std_ms=res.train_time_std * 1e3,
                          train_acc=res.train_acc, test_acc=res.test_acc,
                          ok=bool(ok), loss_first=res.losses[0],
                          loss_last=res.losses[-1], launches=launches,
                          peak_gib=peak)
        del gt, ggraph, gnp, ds, model

    out["seconds"] = time.perf_counter() - t_start
    out["line"] = line
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("isplib_tpu_torch.bench: torch.cuda.is_available() is false; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("plan build: %(message)s"))
    logger = logging.getLogger("isplib_tpu_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        # nothing but the line reaches stdout
        with contextlib.redirect_stdout(sys.stderr):
            out = run(argv)
            log("stages: " + json.dumps({key: v for key, v in out.items()
                                         if key != "line"}))
    finally:
        logger.removeHandler(handler)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
