#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (isplib_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``isplib_tpu_torch/kernels/csrc`` (one nvcc
   per source, in parallel).
2. Makes two GCN-signal graphs of 5.73M edges from seeds (``bench.py``'s
   ``gen_gcnsig_graph``: 602 features, 41 classes), sized as ``bench.py``
   sizes its graphs: reddit-sim at scale 0.05 (~690 edges per 128x128
   block: every block is dense, so the dense-block kernel carries it) and
   the density-representative node count (~35 edges per block, as in the
   full Reddit graph, so the residual kernel carries a large share).
   ``auto_tile`` builds the sum/mean plans of A and Aᵀ and the max/min plan.
3. Sum/mean kernels (K1, K2), on both graphs: forward (A) and transpose
   (Aᵀ) plans at K = 32 and 41, and forward at K = 602 (the first layer of
   GraphSAGE-mean and GIN).  Holds each kernel against its plain PyTorch
   version (same rounding, so only the sum order differs: atol =
   1e-4·max|plain|; K1 against the plain function evaluated in float64,
   the fp32 plain version's own error logged beside it, as K8's) and the
   hybrid SpMM against the fp32 reference (bf16 contract: rtol = atol/max
   = 2e-2); times the kernel, its plain version
   and the one PyTorch call that computes the same product
   (``torch.sparse.mm`` on a CSR tensor, the yardstick ``library_ms``) with
   CUDA events, beside the bound max(bytes / 3.35 TB/s, operations / peak)
   of that call's inputs.
4. Max/min kernel (K3), on both graphs, max and min, at K = 32, 41 and 602,
   logged with the max/min walk its schedule takes (edges, items, split
   rows): out bit for bit and arg exactly equal to the plain version
   (exact fp32), and equal as numbers to the reference path; times the
   kernel, its plain version and ``scatter_reduce_(..., "amax"|"amin",
   include_self=False)`` over precomputed (E, K) messages (values only, no
   winning ids: no PyTorch call returns them), beside the bound.
5. The paths, each driven with every kernel's launch count set to 0 just
   before it and read just after; the paths run on the plans that steps
   3-4 checked:
   * GCN(602 → 32 → 41), 30 epochs on each graph (K1, K2);
   * GraphSAGE(602 → 32 → 41, aggr="max"), 30 epochs on each graph (K3);
   * on reddit-sim, 10 epochs each: GraphSAGE min (K3), GraphSAGE mean and
     GIN (K1/K2);
   * the CLI in-process: ``run_model sage reddit-sim --aggr max --scale 0.05
     --epochs 2`` (K3).
   Checks: the path's kernels launched, the loss is finite and falls; for
   GCN and GraphSAGE-max train accuracy above 0.7 (``bench.py``'s check);
   the trained model's loss through the kernels against the reference path
   (a plain CSRGraph): 1e-4 relative for max/min (the aggregation is exact),
   2e-2 for sum/mean (the bf16 contract of K2).
6. Profiles five more epochs per graph of GCN and of GraphSAGE-max with
   ``torch.profiler``: the device's busy time per epoch, its idle share,
   and the time by kernel.
7. SDDMM and FusedMM (K4, K5, K6) on ``scripts/bench_fused.py``'s graph:
   the R-MAT reddit stand-in, ``gen_rmat_graph(11648, 5730794,
   crc32("reddit"), 4096)``, tiled by ``build_tiling``.  K4 at K = 32, 41
   and 602 on it and on the density-representative graph; K5 and both
   passes of K6 for the sigmoid embedding kernel, the t-distribution force
   model and COPY_RHS + MEAN at K = 32, 41 and 256.  Each held against its
   plain version at 1e-4·max|plain| and timed beside its bound (and its
   share of it) and, where one PyTorch call computes the same function,
   that call (``torch.sparse.sampled_addmm`` for K4; for COPY_RHS + MEAN
   ``torch.sparse.mm`` of A with the mean's values times y for K5, and of
   Aᵀ with the CSC values times g for K6, whose pass B alone runs there;
   none for the SOP pipelines).  Then the paths, each with the launch
   counts set to 0 just before it:
   * the FusedMM path: per SOP pipeline, 20 Adam steps on x, y (11648×32,
     ``default_rng(0)``) with loss ``0.5e-6·Σ fused_mm(tiled, x, y, op)²``
     (``bench_fused.py``'s loss); K5 and K6 must launch, the loss be finite
     and fall, the step-0 gradients match the plain path's at 1e-4 of their
     scale, and the final loss through the kernels match the plain CSRGraph
     path's at 1e-4 relative; the step is timed and profiled;
   * the SDDMM path: one backward of ``spmm(tiled, x, "sum")`` with edge
     values that require a gradient on the density-representative graph
     (K4 computes ``grad_value``), and the public ``sddmm`` forward and
     backward, each against the plain formula, then profiled;
   * the fused max route: ``fused_mm`` with AOP = MAX (K3), forward and
     grad against the plain path.
8. The row-sharded path (``isplib_tpu_torch.dist``) on a 4-shard
   ``LocalMesh``: ``partition_rows`` of reddit-sim (version 5 with the
   max/min plans, and version 2) and of density-rep (version 5), each
   logged with rows per shard, halo, halo fraction, build seconds and every
   plan's bytes and fill.  K8 on shard 0's local and halo forward plans
   at K = 32 and 602 and on its two transpose plans at K = 32 and 41
   against its plain version evaluated in float64 (1e-4·max|plain|: the
   kernel and the fp32 plain version, whose error is logged beside it,
   both sum in a run-to-run order) and K7 on both halves, max and min, at K = 32, 41
   and 602, bit for bit, logged with its walk; each timed beside
   ``torch.sparse.mm`` of the same edges (K8) or ``scatter_reduce_``
   values only (K7) and the bound (the real edges' planes, the x tile of
   every non-empty cell, the outputs).
   Then the paths, 30 epochs each: GCN on the version-5 route (K1/K2, both
   graphs) and on the version-2 route (K8), GraphSAGE-max (K7); the loss
   falls, train accuracy above 0.7, and the trained loss on the sharded
   graph against the unsharded TiledGraph (2e-2 relative where the
   sharded route runs K2's bf16 blocks too, version 5; 1e-3 for the fp32
   K8 of version 2, whose gap is K2's rounding alone; 1e-4 for max).
   Profiles five more epochs of the sharded GCN (version 5) and
   GraphSAGE-max on reddit-sim.  Last, the one-shard partition through a
   one-rank ``GroupMesh`` over NCCL: sum (K1/K2), max (K7) and the
   reference route (NCCL's all_to_all) against the unsharded kernels, and
   its time against the unsharded hybrid SpMM (the sharded path's
   overhead).
9. The autotuner and plan generations 1-5, with a fresh tune cache and
   plan cache in a temporary directory (removed at the end).  Every
   ``DEFAULT_CONFIGS`` entry is built for A and Aᵀ on both graphs (bytes,
   fill and build seconds logged) and its SpMM at K = 32 held against the
   fp32 reference (2e-2 where bf16 blocks carry edges, versions 5 and 3;
   1e-4·max|ref| for versions 2 and 1); ``tune_spmm`` at K = 32 then times
   those builds (every configuration's ms and Gedges/s, the winner) and
   saves the winner's plans, so no plan is built twice.  K9 on
   density-rep's v3 plans (threshold 64, g = 32; reddit-sim's residual is
   empty there) and K10 on both graphs' v1 plans, forward and transposed at
   K = 32, 41 and 602, each against its plain version at
   1e-4·max|plain| (K10 as K8: evaluated in float64) and timed beside ``torch.sparse.mm`` of the same edges
   and the bound (K9's operations at the bf16 tensor-core rate); then the
   same for K8 on density-rep's full version-2 plan (256/512/512) and on
   its version-3 residual; then the split paths on density-rep's plans,
   forward and transposed, at the same widths: K9 with its schedule cut
   into pieces of 4 members, K2 (on the ``auto_tile`` plans of step 2)
   into pieces of 4 blocks, and K10 and K8 into items of 32 slots (K8 also
   adding into an output it is given), against the plain versions.  Then
   ``auto_tile`` of a fresh CSRGraph of the same
   arrays, which must load the winner's plans from the plan cache (equal
   to the winner's, load time against build time), 10 GCN epochs on it,
   and GCN through versions 3 (K9 + K8), 1 (K10) and 2 (K8) on
   density-rep, 10 epochs each, against the reference path (2e-2 for
   version 3, 1e-4 for versions 1 and 2).
10. Interop and the training tools (``isplib_tpu_torch.interop``,
   ``make_train_step``, checkpoints, profiling, ``findbestk``), at GCN's
   widths (602 → 32 → 41).  Parts a-g and i run on a fresh tune cache, so
   that ``auto_tile`` takes the occupancy rule:
   a. ``spmm`` on a plain CUDA CSRGraph of density-rep at K = 32: K1 and K2
      launch, ``auto_tile`` builds once (a second call builds nothing), the
      result holds the fp32 reference under the bf16 contract (2e-2), and
      the call is timed beside ``spmm`` on the tiled graph;
   b. the reference's A/B: ``train_torch_baseline("gcn")``, 10 epochs on
      density-rep, unpatched (``torch.sparse.mm`` is cuSPARSE: K1/K2 launch
      0 times) and inside ``isplib_autotune`` from the same seed (K1/K2
      launch; the bridge builds its graph once and ``auto_tile`` builds
      its v5 plans once for both layers, K = 32 and 41, which fall in two
      K buckets); losses finite and falling, the
      final losses within 2e-2, ``torch.sparse.mm`` restored; both epoch
      times (CUDA events) and their ratio;
   c. a fake ``torch_sparse`` module, patched: ``matmul(SparseTensor,
      x, reduce="max")`` on reddit-sim at K = 32 launches K3, and its output
      and ``grad_x`` equal ``spmm(tiled, x, "max")``'s bit for bit
      (``index_add_`` in its deterministic form for both);
   d. ``torch.profiler`` over one cache-hit forward + backward of
      ``torch_spmm`` and of the same direct ``spmm(tiled, x)``: the bridge
      makes no more host<->device copies than the direct call, each count
      from a capture that recorded every K2 launch of the call (the
      profiler can drop device records; a capture is retried up to 10
      times, the card spun busy around the call);
   e. ``make_train_step``: 10 GCN steps on density-rep against
      ``train_node_classifier(epochs=10)`` from the same init and seed, the
      losses within 1e-4 (K1 adds split rows by atomics);
   f. 5 steps, ``save_checkpoint`` (parameters, Adam state, the dropout
      generator), ``restore_checkpoint`` into a fresh model and optimizer, 5
      more steps, against the 10 uninterrupted steps of e at 1e-4; the
      checkpoint's bytes and its save and load seconds;
   g. ``utils.trace`` over one GCN epoch names K1's and K2's kernels, and a
      ``Timer`` section with ``sync=`` is at least the CUDA-event time of
      the same epoch;
   h. ``findbestk.sweep`` on density-rep at K = 32 and 41 with phase 9's
      caches, its table, and ``auto_tile`` at K = 41 of a fresh graph of
      the same arrays takes the recorded winner from the plan cache
      (building nothing);
   i. ``torch_spmm`` on density-rep with a new value tensor on each of
      ``CACHE_SIZE`` + 2 calls (PyG's ``GCNConv`` with ``cached=False``):
      one graph and plan build a call, and once the cache is full its
      entries, ``auto_tile``'s memo and the device memory stay flat.

11. The main path on the full graph: reddit-sim at scale 1.0 (232,965
   nodes, 114.8M edges with self loops; ``bench.py``'s reddit at its full
   size), drawn from R-MAT's native stream and built by the port's native
   builder, the host seconds of each step logged (R-MAT, ``_build_arrays``,
   the upload, ``auto_tile``'s v5 plans of A and Aᵀ), with the dense
   threshold that the 2 GiB block cap sets and its coverage.  K2 and K1
   against their plain versions and the hybrid SpMM at K = 32 against the
   fp32 reference computed over ranges of rows (2e-2), timed beside the
   bound; then GCN(602 → 32 → 41), ``FULL_EPOCHS`` epochs through K1 + K2
   (with the launch counts set to 0 just before) and the same epochs on
   the reference path from the same seed: the losses finite and falling,
   within 2e-2 of each other at every epoch, the trained model's loss
   through the kernels against the reference path (2e-2), train accuracy
   above 0.7; the peak device memory.
12. The measuring entry points.  For both GCN-signal graphs of step 2,
   step 3's whole-hybrid bound at K = 32 must equal ``nnz /
   plan_bound_edges_per_s`` of the same tiled graph (1e-9 relative): both
   come from ``isplib_tpu_torch/utils/roofline.py``, the one cost model of
   the plans.  Then ``python -m isplib_tpu_torch.bench --iters 20`` (scale
   0.05) and ``python -m isplib_tpu_torch.bench_fused --iters 10``, each a
   subprocess with a fresh graph, plan and tune cache, its stderr logged:
   both exit 0; the bench prints exactly one JSON line on stdout, metric
   ``spmm_sum_edges_per_s_k32_reddit``, value > 0, 0 < vs_baseline <= 1;
   its GCN and shard stages log OK; both fused pipelines' errors, forward
   and forward + backward, are at most 1e-4 relative; and every stage
   launched the kernels of its plans (the launch counts each bench logs
   in its last ``stages:`` line).

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line; every
number it measures is logged on the lines before.  Any failed check raises:
the exit code is then non-zero and the last line is not printed.  Without a
CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

from isplib_tpu_torch.utils.roofline import (BF16_TENSOR_FLOPS, FP32_FLOPS,
                                             bound_ms, cost_bound_ms,
                                             plan_bound_edges_per_s,
                                             plan_cost, v2_cost)

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py's reddit configuration (DATASET_STATS["reddit"]) at its default
# scale 0.05, and its seed rule
N_REAL, E_REAL, FEATURES, CLASSES = 232_965, 114_615_892, 602, 41
SCALE = 0.05
SEED = zlib.crc32(b"reddit") & 0x7FFFFFFF
EDGE_MULTIPLE = 4096
EPOCHS = 30
SHORT_EPOCHS = 10         # the other new models, at a smaller depth
KS = (32, 41)             # GCN's SpMM widths, forward and over Aᵀ
K_WIDE = 602              # the first layer of GraphSAGE and GIN
MM_KS = (32, 41, K_WIDE)
# scripts/bench_fused.py's graph and width
RMAT_NODES, RMAT_EDGES, FUSED_K = 11_648, 5_730_794, 32
FUSED_KS = (FUSED_K, 41, 256)   # the embedding width, a ragged and the widest
SDDMM_KS = (32, 41, K_WIDE)
FUSED_STEPS = 20
TUNE_ITERS = 10           # chain_time calls per configuration in the sweep
FULL_EPOCHS = 30          # phase 11's GCN epochs on the full graph, each path
REF_EDGES = 1 << 24       # edges a range of rows of the reference SpMM takes
SPIN_CYCLES = 4_000_000   # ~2 ms of the card's clock around a profiled call
LEAD_KERNELS = 16         # small kernels that open a profiled window
BENCH_K = 32              # the bench's headline width (its default --k)
BENCH_METRIC = "spmm_sum_edges_per_s_k32_reddit"
BENCH_TOL = 1e-4          # bench_fused's errors, forward and backward
BENCH_TIMEOUT = 600       # seconds each bench subprocess may take


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list[tuple[str, str]]:
    """(kernel, "registers; stack and spills") for each entry function of an
    ``-Xptxas -v`` report, the names demangled where ``c++filt`` exists."""
    entries, fn, frame = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn, frame = line.split("Function properties for")[1].strip(), ""
        elif fn and "stack frame" in line:
            frame = line.strip()
        elif fn and "Used" in line and "registers" in line:
            used = line.split("Used")[1].split(",")[0].strip()
            entries.append((fn, f"{used}; {frame}"))
            fn = None
    tool = shutil.which("c++filt")
    if tool and entries:
        names = subprocess.run(
            [tool], input="\n".join(n for n, _ in entries),
            capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(entries):
            entries = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                        .removeprefix("void "), props)
                       for n, (_, props) in zip(names, entries)]
    return entries


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def csr(rowptr, col, val, shape):
    return torch.sparse_csr_tensor(rowptr.long(), col.long(), val,
                                   size=shape, check_invariants=False)


def dense_half_csr(plan, graph):
    """The dense half's edges as a CSR tensor (fp32 values), for the
    library yardstick of the dense-block kernel."""
    from isplib_tpu_torch.sparse.tiling_v5 import BS
    n = graph.nnz
    row, col, val = graph.row[:n].long(), graph.col[:n].long(), \
        graph.value[:n]
    n_bc = -(-graph.num_cols // BS)
    br = torch.repeat_interleave(
        torch.arange(plan.n_br, device=row.device),
        plan.blk_rowptr.diff().long())
    dense_ids = br * n_bc + plan.blk_col.long()
    is_dense = torch.isin((row // BS) * n_bc + col // BS, dense_ids)
    d_row = row[is_dense]
    rowptr = torch.zeros(graph.num_rows + 1, dtype=torch.long,
                         device=row.device)
    rowptr[1:] = torch.cumsum(torch.bincount(d_row,
                                             minlength=graph.num_rows), 0)
    return csr(rowptr, col[is_dense], val[is_dense], graph.shape)


def reference_by_rows(g, x):
    """The fp32 reference SpMM (sum) of ``g``, computed over ranges of rows
    of at most ``REF_EDGES`` edges (a hub row whole), so that the gathered
    (edges, K) temporaries stay within a few GB at 114.6M edges."""
    from isplib_tpu_torch.ops import reference
    rowptr = g.rowptr.cpu().numpy().astype(np.int64)
    out = x.new_empty(g.num_rows, x.shape[1])
    r0 = 0
    while r0 < g.num_rows:
        r1 = int(np.searchsorted(rowptr, rowptr[r0] + REF_EDGES,
                                 side="right")) - 1
        r1 = min(max(r1, r0 + 1), g.num_rows)
        e0, e1 = int(rowptr[r0]), int(rowptr[r1])
        out[r0:r1] = reference.spmm_raw(g.row[e0:e1] - r0, g.col[e0:e1],
                                        g.value[e0:e1], g.deg[r0:r1], x,
                                        r1 - r0, "sum")
        r0 = r1
    return out


def check_and_time(name, graph, tiled, direction, k, gen):
    """One (graph, direction, K) case: both kernels against their plain
    versions, the hybrid against the fp32 reference, and the timings."""
    from isplib_tpu_torch.kernels import spmm_bsr, spmm_stream
    from isplib_tpu_torch.kernels.spmm_hybrid import spmm_hybrid

    plan = tiled.fwd if direction == "fwd" else tiled.bwd
    g = graph if direction == "fwd" else graph.transpose()
    x = torch.randn(plan.num_cols, k, device=gen.device, generator=gen)
    rows = []

    # ---- K2: dense blocks -------------------------------------------------
    got = spmm_bsr.spmm_bsr(plan, x)
    want = spmm_bsr.spmm_bsr_plain(plan, x)
    torch.cuda.synchronize()
    err2 = float((got - want).abs().max()) if plan.nb else 0.0
    tol2 = 1e-4 * float(want.abs().max())
    if plan.nb and not err2 <= tol2:
        raise AssertionError(f"spmm_bsr {name}/{direction}/K={k}: max err "
                             f"{err2} > {tol2}")
    lib_d = dense_half_csr(plan, g)
    blk_cols = int(torch.unique(plan.blk_col).numel())
    rows.append(dict(
        kernel="spmm_bsr", graph=name, direction=direction, k=k,
        max_abs_err=err2, tol=tol2,
        ms=cuda_ms(lambda: spmm_bsr.spmm_bsr(plan, x)),
        plain_ms=cuda_ms(lambda: spmm_bsr.spmm_bsr_plain(plan, x), iters=5),
        library_ms=cuda_ms(lambda: torch.sparse.mm(lib_d, x)),
        bound=bound_ms(
            plan.nb * 128 * 128 * 2 + (plan.n_br + 1 + plan.nb) * 4
            + min(blk_cols * 128, plan.num_cols) * k * 4
            + plan.num_rows * k * 4,
            2.0 * plan.nb * 128 * 128 * k, BF16_TENSOR_FLOPS)))

    # ---- K1: residual edges, from a zero output, against the plain
    # function in float64 (the fp32 plain version's index_add_ sums in a
    # run-to-run order too: its own error is logged) -----------------------
    got1 = torch.zeros(plan.num_rows, k, device=x.device)
    want1 = torch.zeros_like(got1)
    spmm_stream.spmm_stream(plan, x, got1)
    exact = spmm_stream.spmm_stream_oracle(plan, x, want1)
    spmm_stream.spmm_stream_plain(plan, x, want1)
    torch.cuda.synchronize()
    err1 = float((got1 - exact).abs().max())
    tol1 = 1e-4 * float(exact.abs().max())
    plain_err1 = float((want1 - exact).abs().max())
    del exact
    if not (bool(torch.isfinite(got1).all()) and err1 <= tol1):
        raise AssertionError(f"spmm_stream {name}/{direction}/K={k}: max err "
                             f"{err1} > {tol1}")
    lib_r = csr(plan.res_rowptr, plan.res_col, plan.res_val, g.shape)
    used_cols = int(torch.unique(plan.res_col).numel())
    used_rows = int((plan.res_rowptr.diff() > 0).sum())
    rows.append(dict(
        kernel="spmm_stream", graph=name, direction=direction, k=k,
        max_abs_err=err1, tol=tol1, plain_err=plain_err1,
        ms=cuda_ms(lambda: spmm_stream.spmm_stream(plan, x, got1)),
        plain_ms=cuda_ms(lambda: spmm_stream.spmm_stream_plain(plan, x,
                                                                 want1),
                         iters=5),
        library_ms=cuda_ms(lambda: torch.sparse.mm(lib_r, x)),
        bound=bound_ms(
            plan.sparse_edges * 8 + (plan.num_rows + 1) * 4
            + (2 * plan.nseg + 1) * 4 + used_cols * k * 4
            + 2 * used_rows * k * 4,
            2.0 * plan.sparse_edges * k, FP32_FLOPS)))

    # ---- the whole hybrid SpMM against the fp32 reference ------------------
    hyb = spmm_hybrid(plan, x)
    ref = reference_by_rows(g, x)
    scale = float(ref.abs().max())
    herr = float((hyb - ref).abs().max())
    if not bool(torch.isfinite(hyb).all()) or not torch.allclose(
            hyb, ref, rtol=2e-2, atol=2e-2 * scale):
        raise AssertionError(f"hybrid {name}/{direction}/K={k} vs reference: "
                             f"max err {herr} (max |ref| {scale})")
    lib_all = csr(g.rowptr, g.col[:g.nnz], g.value[:g.nnz], g.shape)
    # the whole SpMM's bound is the plan's (utils/roofline.py), as the bench's
    whole = dict(max_abs_err=herr, max_abs_ref=scale,
                 hybrid_ms=cuda_ms(lambda: spmm_hybrid(plan, x)),
                 library_ms=cuda_ms(lambda: torch.sparse.mm(lib_all, x)),
                 bound=cost_bound_ms(*plan_cost(plan, k)))
    return rows, whole


def check_and_time_minmax(name, graph, tiled, reduce, k, gen):
    """One (graph, reduce, K) case of the max/min kernel: against its plain
    version bit for bit, against the reference path as numbers, and the
    timings."""
    from isplib_tpu_torch.kernels import spmm_minmax_v4 as k3
    from isplib_tpu_torch.ops import reference

    plan, sentinel = tiled.fwd_mm, graph.nnz_padded - 1
    x = torch.randn(graph.num_cols, k, device=gen.device, generator=gen)

    def kernel():
        return k3.spmm_minmax_v4(plan, graph.col, graph.value, x, reduce,
                                 sentinel)

    def plain():
        return k3.spmm_minmax_v4_plain(plan, graph.col, graph.value, x,
                                       reduce, sentinel)

    (out, arg), (pout, parg) = kernel(), plain()
    torch.cuda.synchronize()
    bad_bits = int((out.view(torch.int32) != pout.view(torch.int32)).sum())
    bad_args = int((arg != parg).sum())
    err = float((out - pout).abs().max())
    if bad_bits or bad_args:
        raise AssertionError(f"spmm_minmax_v4 {name}/{reduce}/K={k}: "
                             f"{bad_bits} values differ in their bits, "
                             f"{bad_args} args differ (max err {err})")
    rout, rarg = reference.spmm_arg_raw(graph.row, graph.col, graph.value,
                                        graph.deg, x, graph.num_rows, reduce)
    if not (bool((out == rout).all()) and torch.equal(arg, rarg)):
        raise AssertionError(f"spmm_minmax_v4 {name}/{reduce}/K={k} differs "
                             "from the reference path")
    del pout, parg, rout, rarg

    # the yardstick: one PyTorch call for the values only, its (E, K)
    # messages precomputed outside the timed region
    n = graph.nnz
    msgs = graph.value[:n, None] * x.index_select(0, graph.col[:n])
    idx = graph.row[:n].long()[:, None].expand(-1, k)
    lib_out = torch.zeros(graph.num_rows, k, device=x.device)
    lib_ms = cuda_ms(lambda: lib_out.scatter_reduce_(
        0, idx, msgs, "amax" if reduce == "max" else "amin",
        include_self=False))
    del msgs, lib_out

    used_cols = int(torch.unique(graph.col[:n]).numel())
    wide = k > 64
    return dict(
        kernel="spmm_minmax_v4", graph=name, reduce=reduce, k=k,
        max_abs_err=err, walk=walk_line(plan.sched, n),
        ms=cuda_ms(kernel, iters=10 if wide else 30),
        plain_ms=cuda_ms(plain, iters=2 if wide else 5, warmup=1),
        library_ms=lib_ms,
        bound=bound_ms(
            (graph.num_rows + 1) * 4 + n * 8 + (2 * plan.nseg + 1) * 4
            + used_cols * k * 4 + graph.num_rows * k * 8,
            2.0 * n * k, FP32_FLOPS))


def walk_line(s, edges: int) -> str:
    """The max/min walk a schedule takes (K3, K7)."""
    return (f"{edges} edges in {s.nseg} items of <= {s.item_edges}; "
            f"{s.nsplit} split rows")


def check_near_plain(label, got, want):
    """A kernel against its plain version (or a path against the plain
    path): within 1e-4·max|plain|, the kernel being fp32 and summing in
    another order; returns the max error and the tolerance."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = 1e-4 * float(want.abs().max()) if want.numel() else 0.0
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"{label}: max err {err} > {tol}")
    return err, tol


def used(idx):
    return int(torch.unique(idx).numel())


def check_and_time_sddmm(name, graph, tiled, k, gen):
    """K4 at (graph, K): against its plain version, and the timings beside
    ``torch.sparse.sampled_addmm`` over the same pattern and the bound."""
    from isplib_tpu_torch.kernels import sddmm as k4

    plan, n = tiled.fwd_mm, graph.nnz
    a = torch.randn(graph.num_rows, k, device=gen.device, generator=gen)
    b = torch.randn(graph.num_cols, k, device=gen.device, generator=gen)
    err, tol = check_near_plain(
        f"sddmm {name} K={k}", k4.sddmm(plan, graph.col, a, b),
        k4.sddmm_plain(plan, graph.col, a, b))
    pattern = csr(graph.rowptr, graph.col[:n],
                  torch.zeros(n, device=a.device), graph.shape)
    bt = b.t().contiguous()
    lib = torch.sparse.sampled_addmm(pattern, a, bt, beta=0.0)
    lib_err = float((lib.values() - k4.sddmm_plain(plan, graph.col, a, b)[
        :n]).abs().max())
    wide = k > 64
    return dict(
        kernel="sddmm", graph=name, case="dot", k=k, max_abs_err=err,
        tol=tol, lib_err=lib_err,
        ms=cuda_ms(lambda: k4.sddmm(plan, graph.col, a, b)),
        plain_ms=cuda_ms(lambda: k4.sddmm_plain(plan, graph.col, a, b),
                         iters=2 if wide else 5, warmup=1),
        library_ms=cuda_ms(lambda: torch.sparse.sampled_addmm(
            pattern, a, bt, beta=0.0)),
        bound=bound_ms(
            (2 * plan.nseg + 1) * 4 + n * 8
            + (used(graph.row[:n]) + used(graph.col[:n])) * k * 4,
            2.0 * n * k, FP32_FLOPS))


def fused_ops_per_edge_feature(op, backward: bool) -> int:
    """fp32 operations per edge and feature that the function needs, an
    FMA counting 2 and the per-edge scalars (the SOP, its derivative, the
    weight) left out.  Forward: the VOP, the ROP and the accumulation s·v.
    A backward pass: where the ROP is not NOOP, v again, t, <g, v> and the
    ROP's chain term (+ŝ, or 2ŝ·v); then s·g, and its accumulation, an FMA
    where dVOP/d(own) varies by feature (MUL, MAX, MIN), else an add."""
    from isplib_tpu_torch import ReduceOp, VectorOp
    vop = 0 if op.vop in (VectorOp.COPY_RHS, VectorOp.COPY_LHS) else 1
    rop = {ReduceOp.NOOP: 0, ReduceOp.DOT: 1, ReduceOp.NORM2: 2}[op.rop]
    if not backward:
        return vop + rop + 2
    chain = vop + rop + 2 + rop if rop else 0
    varies = op.vop in (VectorOp.MUL, VectorOp.MAX, VectorOp.MIN)
    return chain + 1 + (2 if varies else 1)


def fused_operands(op, side: str) -> set:
    """The operands among x, y and g that a FusedMM function reads, for
    ``side`` "fwd" (K5), "A" (K6 pass A, grad_x) or "B" (pass B, grad_y):
    forward the VOP's; a backward pass g, the VOP's where the ROP needs v,
    and those dVOP/d(own) depends on (the other side's for MUL, both for
    MAX and MIN)."""
    from isplib_tpu_torch import ReduceOp, VectorOp
    reads = {VectorOp.COPY_RHS: {"y"}, VectorOp.COPY_LHS: {"x"}}.get(
        op.vop, {"x", "y"})
    if side == "fwd":
        return reads
    need = {"g"} | (reads if op.rop is not ReduceOp.NOOP else set())
    if op.vop is VectorOp.MUL:
        need.add("y" if side == "A" else "x")
    if op.vop in (VectorOp.MAX, VectorOp.MIN):
        need |= {"x", "y"}
    return need


def check_and_time_fused(pname, op, graph, tiled, k, gen):
    """K5 and both passes of K6 for one pipeline at K: against their plain
    versions, and the timings beside the bound (and ``torch.sparse.mm`` for
    COPY_RHS + MEAN, the one pipeline a PyTorch call computes)."""
    from isplib_tpu_torch import ScaleOp, VectorOp
    from isplib_tpu_torch.kernels import fused as k5
    from isplib_tpu_torch.kernels import fused_bwd as k6
    from isplib_tpu_torch.ops import reference

    n, r, c = graph.nnz, graph.num_rows, graph.num_cols
    x = torch.randn(r, k, device=gen.device, generator=gen)
    y = torch.randn(c, k, device=gen.device, generator=gen)
    g = torch.randn(r, k, device=gen.device, generator=gen)
    if op.vsc is ScaleOp.MEAN:
        g = g / graph.deg.clamp(min=1.0)[:, None]
    fwd = (tiled.fwd_mm, graph.col, graph.value, graph.deg, x, y, op)
    want5 = k5.fused_plain(*fwd)  # float64 inside
    err5, tol5 = check_near_plain(f"fused {pname}", k5.fused(*fwd), want5)
    # the same reference formulation in fp32, for the record
    ref32 = reference.fused_mm_raw(tiled.fwd_mm.edge_rows(), graph.col[:n],
                                   graph.value[:n], graph.deg, x, y, r, op)
    ref32_err = float((ref32 - want5).abs().max())
    del want5, ref32
    passes = [(tiled.bwd_mm, graph.csc_col, graph.csc_value, x, y, g, op,
               True)]
    if op.vop is not VectorOp.COPY_RHS:
        passes.insert(0, (tiled.fwd_mm, graph.col, graph.value, x, y, g, op,
                          False))
    err6 = tol6 = 0.0
    for args in passes:
        e, t = check_near_plain(f"fused_bwd {pname} pass "
                                f"{'B' if args[-1] else 'A'}",
                                k6.fused_bwd(*args), k6.fused_bwd_plain(*args))
        err6, tol6 = max(err6, e), max(tol6, t)

    def bwd():
        for args in passes:
            k6.fused_bwd(*args)

    def bwd_plain():
        for args in passes:
            k6.fused_bwd_plain(*args)

    # bytes: the segment list, col (and val but under VSC_NONE), the rows
    # of the operands the function reads, each once (x and g rows of edges,
    # y rows of columns), the degrees for MEAN, the output
    row_bytes = {"x": used(graph.row[:n]) * k * 4, "g": used(
        graph.row[:n]) * k * 4, "y": used(graph.col[:n]) * k * 4}
    edge_bytes = n * (4 if op.vsc is ScaleOp.NONE else 8)

    def side_bytes(plan, side, out_rows):
        return ((3 * plan.nseg + 1) * 4 + edge_bytes + out_rows * k * 4
                + sum(row_bytes[o] for o in fused_operands(op, side)))

    fwd_bytes = (side_bytes(tiled.fwd_mm, "fwd", r)
                 + (r * 4 if op.vsc is ScaleOp.MEAN else 0))
    bwd_bytes = sum(side_bytes(args[0], "B" if args[-1] else "A",
                               c if args[-1] else r) for args in passes)
    lib_ms = lib6_ms = None
    if op.vop is VectorOp.COPY_RHS and op.vsc is ScaleOp.MEAN:
        # forward: A with the mean's values times y; backward (pass B
        # alone): Aᵀ with the CSC values times g (already divided by the
        # degree, as FusedMM.backward hands it over)
        mean_vals = (graph.value[:n]
                     / graph.deg.clamp(min=1.0)[graph.row[:n].long()])
        lib = csr(graph.rowptr, graph.col[:n], mean_vals, graph.shape)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(lib, y))
        lib_t = csr(graph.csc_colptr, graph.csc_col[:n],
                    graph.csc_value[:n], (c, r))
        lib6_ms = cuda_ms(lambda: torch.sparse.mm(lib_t, g))
    plain_iters = dict(iters=2, warmup=1) if k > 64 else dict(iters=5)
    out = [dict(kernel="fused", graph="rmat", case=pname, k=k,
                max_abs_err=err5, tol=tol5, ref32_err=ref32_err,
                ms=cuda_ms(lambda: k5.fused(*fwd)),
                plain_ms=cuda_ms(lambda: k5.fused_plain(*fwd),
                                 **plain_iters),
                library_ms=lib_ms,
                bound=bound_ms(fwd_bytes, fused_ops_per_edge_feature(
                    op, False) * n * k, FP32_FLOPS)),
           dict(kernel="fused_bwd", graph="rmat", case=pname, k=k,
                passes=len(passes), max_abs_err=err6, tol=tol6,
                ms=cuda_ms(bwd), plain_ms=cuda_ms(bwd_plain, **plain_iters),
                library_ms=lib6_ms,
                bound=bound_ms(
                    bwd_bytes, len(passes) * fused_ops_per_edge_feature(
                        op, True) * n * k, FP32_FLOPS))]
    return out


def fused_train(op, graph, x0, y0, steps):
    """``steps`` Adam steps (lr 0.01) on x and y with bench_fused.py's loss
    through ``fused_mm``; returns the losses, the step-0 gradients, the
    final x, y and the mean step time after the first (CUDA events)."""
    from isplib_tpu_torch import fused_mm

    x = x0.clone().requires_grad_(True)
    y = y0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x, y], lr=0.01)
    losses, grads0 = [], None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        if i == 1:
            start.record()
        opt.zero_grad(set_to_none=True)
        loss = 0.5e-6 * (fused_mm(graph, x, y, op) ** 2).sum()
        loss.backward()
        if i == 0:
            grads0 = (x.grad.clone(), y.grad.clone())
        opt.step()
        losses.append(loss.item())
    end.record()
    end.synchronize()
    return (losses, grads0, x.detach(), y.detach(),
            start.elapsed_time(end) / max(steps - 1, 1))


def profile_epochs(model, graph, arrays, epochs: int = 5):
    """Where an epoch's time goes: ``torch.profiler`` over ``epochs`` more
    training epochs (after one untimed); see :func:`profile_steps`."""
    from isplib_tpu_torch.train.loop import _loss_fn

    x = torch.from_numpy(arrays["x"]).cuda()
    y = torch.from_numpy(arrays["y"]).cuda()
    mask = torch.from_numpy(arrays["train_mask"]).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=0.01, weight_decay=5e-4)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        _loss_fn(model(graph, x), y, mask).backward()
        opt.step()

    return profile_steps(step, epochs)


def kernel_share(per_kernel: dict, key: str, busy_ms: float) -> str:
    """The busy time of the kernels whose name holds ``key``, and its share
    of ``busy_ms``."""
    ms = sum(v for kn, v in per_kernel.items() if key in kn)
    return f"{ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)"


def profile_steps(step, epochs: int = 5):
    """``torch.profiler`` over ``epochs`` calls of ``step`` (after one
    untimed), returning the profiled step time on CUDA events, the
    device's busy time per step (kernels, copies and sets; annotation
    ranges excluded) and the busy time per kernel name."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(epochs):
            step()
        end.record()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time
    per_epoch = {k: v / 1e3 / epochs for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])}
    return (start.elapsed_time(end) / epochs, sum(per_epoch.values()),
            per_epoch)


def fused_paths(graphs, cases, drive, gen):
    """Phase 7: K4, K5 and K6 against their plain versions and timed, then
    the FusedMM path, the SDDMM path and the fused max route.  Appends the
    kernel cases to ``cases``; returns the launches of the FusedMM paths
    (summed over both pipelines) and of the SDDMM path."""
    import dataclasses

    from isplib_tpu_torch import (FusedOp, Reduce, ReduceOp, ScalarOp,
                                  ScaleOp, VectorOp, build_tiling, fused_mm,
                                  graph_from_arrays, sddmm, spmm)
    from isplib_tpu_torch.data import gen_rmat_graph
    from isplib_tpu_torch.ops import reference

    t0 = time.perf_counter()
    g = graph_from_arrays(gen_rmat_graph(RMAT_NODES, RMAT_EDGES, SEED,
                                         EDGE_MULTIPLE), "cuda")
    tiled = build_tiling(g)
    torch.cuda.synchronize()
    log(f"rmat (bench_fused.py's graph): {g.num_rows} nodes, {g.nnz} edges, "
        f"max degree {int(g.deg.max())}; {tiled.fwd_mm.nseg} segments "
        f"({tiled.fwd_mm.nsplit} split rows), Aᵀ {tiled.bwd_mm.nseg} "
        f"({tiled.bwd_mm.nsplit}); {time.perf_counter() - t0:.1f}s")

    # ---- the kernels against their plain versions, and their times ------
    for name, (gg, tt) in (("rmat", (g, tiled)),
                           ("density-rep", graphs["density-rep"][1:])):
        for k in SDDMM_KS:
            r = check_and_time_sddmm(name, gg, tt, k, gen)
            cases.append(r)
            log(f"sddmm {name:11s} K={k}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.3f}, library sampled_addmm "
                f"{r['library_ms']:.4f} with max err {r['lib_err']:.3g}, "
                f"bound {r['bound'][0]:.4f} by {r['bound'][1]}), err "
                f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}")
    pipelines = {
        "sigmoid-embed": FusedOp(VectorOp.MUL, ReduceOp.DOT,
                                 ScalarOp.SIGMOID, ScaleOp.MUL, Reduce.SUM),
        "tdist-force": FusedOp(VectorOp.SUB, ReduceOp.NORM2, ScalarOp.TDIST,
                               ScaleOp.MUL, Reduce.SUM),
        "copy_rhs-mean": FusedOp.spmm("mean")}
    for (pname, op), k in itertools.product(pipelines.items(), FUSED_KS):
        for r in check_and_time_fused(pname, op, g, tiled, k, gen):
            cases.append(r)
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"{r['kernel']:9s} {pname:13s} K={k}: {r['ms']:.4f} ms "
                f"(plain {r['plain_ms']:.3f}, library {lib}, bound "
                f"{r['bound'][0]:.4f} by {r['bound'][1]}, "
                f"{100 * r['bound'][0] / r['ms']:.1f}% of it), err "
                f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}"
                + (f"; the fp32 reference formulation {r['ref32_err']:.3g} "
                   "from the float64 plain version" if "ref32_err" in r
                   else ""))

    # ---- the FusedMM path: bench_fused.py's two SOP pipelines -------------
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(RMAT_NODES, FUSED_K)).astype(
        np.float32)).cuda()
    y0 = torch.from_numpy(rng.normal(size=(RMAT_NODES, FUSED_K)).astype(
        np.float32)).cuda()
    fused_launches = {}
    for pname in ("sigmoid-embed", "tdist-force"):
        op = pipelines[pname]
        (losses, grads0, x, y, step_ms), launches = drive(
            f"FusedMM {pname} path", ("fused", "fused_bwd"),
            lambda op=op: fused_train(op, tiled, x0, y0, FUSED_STEPS))
        for kname, count in launches.items():
            fused_launches[kname] = fused_launches.get(kname, 0) + count
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"FusedMM {pname}: loss {losses}")
        # the plain path: step 0's gradients (in float64, the oracle: the
        # fp32 plain path's scatter over hub rows strays by ~1e-4 of the
        # scale, logged beside), a timed step, the final loss
        plain_grads = []
        for dtype in (torch.float64, torch.float32):
            xp = x0.to(dtype, copy=True).requires_grad_(True)
            yp = y0.to(dtype, copy=True).requires_grad_(True)
            (0.5e-6 * (fused_mm(g, xp, yp, op) ** 2).sum()).backward()
            plain_grads.append((xp.grad, yp.grad))
        for i, side in enumerate("xy"):
            exact = plain_grads[0][i]
            err, tol = check_near_plain(
                f"FusedMM {pname} step-0 grad_{side}", grads0[i].double(),
                exact)
            log(f"FusedMM {pname} step-0 grad_{side}: kernels {err:.3g}, "
                f"fp32 plain path "
                f"{float((plain_grads[1][i].double() - exact).abs().max()):.3g}"
                f" from the float64 plain path (tolerance {tol:.3g})")
        del plain_grads
        plain_step_ms = fused_train(op, g, x0, y0, 3)[4]
        with torch.no_grad():
            l_kernel = float(0.5e-6 * (fused_mm(tiled, x, y, op) ** 2).sum())
            l_plain = float(0.5e-6 * (fused_mm(g, x, y, op) ** 2).sum())
        if not abs(l_kernel - l_plain) <= 1e-4 * abs(l_plain):
            raise AssertionError(f"FusedMM {pname}: final loss through the "
                                 f"kernels {l_kernel} vs plain {l_plain}")
        xq, yq = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        opt = torch.optim.Adam([xq, yq], lr=0.01)

        def step(op=op, xq=xq, yq=yq, opt=opt):
            opt.zero_grad(set_to_none=True)
            (0.5e-6 * (fused_mm(tiled, xq, yq, op) ** 2).sum()).backward()
            opt.step()

        prof_ms, busy_ms, per_kernel = profile_steps(step)
        idle = 1.0 - busy_ms / step_ms
        log(f"FusedMM {pname}: loss {losses[0]:.6g} -> {losses[-1]:.6g} in "
            f"{FUSED_STEPS} Adam steps; step {step_ms:.3f} ms through the "
            f"kernels, {plain_step_ms:.3f} ms plain; final loss kernels "
            f"{l_kernel:.7g}, plain {l_plain:.7g}; profile: device busy "
            f"{busy_ms:.3f} ms per step, idle {100 * idle:.1f}% (profiled "
            f"step {prof_ms:.3f} ms); "
            + "; ".join(f"{kn[:48]} {v:.3f}"
                        for kn, v in list(per_kernel.items())[:6]))

    # ---- the SDDMM path: spmm's grad_value and the public sddmm -----------
    _, gd, td = graphs["density-rep"]
    xs = torch.randn(gd.num_cols, FUSED_K, device=gen.device, generator=gen)
    ws = torch.randn(gd.num_rows, FUSED_K, device=gen.device, generator=gen)
    a = torch.randn(gd.num_rows, FUSED_K, device=gen.device, generator=gen)
    b = torch.randn(gd.num_cols, FUSED_K, device=gen.device, generator=gen)
    we = torch.randn(gd.nnz_padded, device=gen.device, generator=gen)

    def sddmm_path():
        v = gd.value.clone().requires_grad_(True)
        (spmm(dataclasses.replace(td, graph=gd.with_value(v)), xs, "sum")
         * ws).sum().backward()
        at, bt = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        s = sddmm(td, at, bt)
        (s * we).sum().backward()
        return v.grad, s.detach(), at.grad, bt.grad

    (gv, s, ga, gb), sddmm_launches = drive("SDDMM path", ("sddmm",),
                                            sddmm_path)
    n = gd.nnz
    want_gv = reference.sddmm_dot_raw(gd.row, gd.col, ws, xs)
    want_gv[n:] = 0
    check_near_plain("SDDMM path grad_value", gv, want_gv)
    at, bt = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want_s = sddmm(gd, at, bt)
    (want_s * we).sum().backward()
    check_near_plain("SDDMM path sddmm", s, want_s.detach())
    check_near_plain("SDDMM path sddmm grad_a", ga, at.grad)
    check_near_plain("SDDMM path sddmm grad_b", gb, bt.grad)
    log(f"SDDMM path: grad_value and sddmm forward and backward agree "
        f"with the plain formula on density-rep ({n} edges)")
    prof_ms, busy_ms, per_kernel = profile_steps(sddmm_path)
    log(f"SDDMM path profile: device busy {busy_ms:.3f} ms per pass "
        f"(profiled pass {prof_ms:.3f} ms), sddmm_kernel "
        f"{kernel_share(per_kernel, 'sddmm_kernel', busy_ms)}; "
        + "; ".join(f"{kn[:48]} {v:.3f}"
                    for kn, v in list(per_kernel.items())[:6]))

    # ---- the fused max route (K3) ------------------------------------------
    op = FusedOp(VectorOp.COPY_RHS, ReduceOp.NOOP, None, ScaleOp.MUL,
                 Reduce.MAX)

    def max_route(graph):
        y = y0.clone().requires_grad_(True)
        out = fused_mm(graph, x0, y, op)
        (out ** 2).sum().backward()
        return out.detach(), y.grad

    (out, gy), _ = drive("fused max route", ("spmm_minmax_v4",),
                         lambda: max_route(tiled))
    want, want_gy = max_route(g)
    check_near_plain("fused max route", out, want)
    check_near_plain("fused max route grad_y", gy, want_gy)
    log("fused max route: out and grad_y agree with the plain path")
    return fused_launches, sddmm_launches


def plan_stats(plan) -> tuple[int, float]:
    """A shard plan's device bytes and fill: the share of real edges among
    a v2 plan's slots, or among a hybrid plan's dense-block entries."""
    from isplib_tpu_torch.sparse.tiling_v2 import TiledPlanV2
    nbytes = plan_bytes(plan)
    if isinstance(plan, TiledPlanV2):
        return nbytes, plan.fill
    return nbytes, plan.dense_edges / max(plan.nb * 128 * 128, 1)


def partition(name, arrays, tiling, shards=4, hold=None):
    """``partition_rows`` of a graph's real edges on the card, logged (rows
    per shard, halo, local and halo edges on stderr): halo fraction, build
    seconds, each plan's bytes and fill."""
    from isplib_tpu_torch.dist import partition_rows

    n = int(arrays["nnz"])
    t0 = time.perf_counter()
    sg = partition_rows(arrays["row"][:n], arrays["col"][:n],
                        arrays["value"][:n], int(arrays["num_rows"]), shards,
                        verbose=True, tiling=tiling, device="cuda",
                        hold=hold)
    torch.cuda.synchronize()
    log(f"partition {name} into {shards} ({tiling}): halo fraction "
        f"{sg.halo_fraction:.4f}, {time.perf_counter() - t0:.1f}s with plans")
    labels = ("loc fwd", "loc bwd", "halo fwd", "halo bwd")
    for i in (sg.held if tiling is not None else ()):
        sh = sg.shard(i)
        named = list(zip(labels, sh.plans))
        if sh.plans_mm is not None:
            named += list(zip(("loc mm", "halo mm"), sh.plans_mm))
        log(f"  shard {i}: " + ", ".join(
            f"{lab} {b / 2**20:.1f} MiB fill {f:.3f}"
            for lab, (b, f) in ((lab, plan_stats(p)) for lab, p in named)))
    return sg


def check_and_time_v2(name, case, plan, k, gen):
    """K8 on one v2 plan at K (a shard plan, a full version-2 plan or a
    version-3 residual): against its plain version evaluated in float64
    (1e-4·max|plain|; the fp32 plain version's own error against it is
    logged: its ``index_add`` sums in a run-to-run order too) and timed
    beside ``torch.sparse.mm`` of the same edges and the bound."""
    from isplib_tpu_torch.kernels import spmm_v2 as k8

    x = torch.randn(plan.num_cols, k, device=gen.device, generator=gen)
    want = k8.spmm_v2_plain(plan, x.double())
    err, tol = check_near_plain(f"spmm_v2 {name} {case} K={k}",
                                k8.spmm_v2(plan, x), want)
    plain_err = float((k8.spmm_v2_plain(plan, x) - want).abs().max())
    del want
    s = plan.slots()
    keep = s["val"] != 0
    lib = torch.sparse_coo_tensor(
        torch.stack([s["row"][keep], s["col"][keep]]), s["val"][keep],
        (plan.num_rows, plan.num_cols)).coalesce().to_sparse_csr()
    real = int(keep.sum())
    del s, keep
    wide = k > 64
    return dict(kernel="spmm_v2", graph=name, case=case, k=k,
                max_abs_err=err, tol=tol, plain_err=plain_err,
                fill=plan.fill, nc=plan.nc,
                edges=real, nseg=plan.sched.nseg,
                ms=cuda_ms(lambda: k8.spmm_v2(plan, x)),
                plain_ms=cuda_ms(lambda: k8.spmm_v2_plain(plan, x),
                                 iters=2 if wide else 5, warmup=1),
                library_ms=cuda_ms(lambda: torch.sparse.mm(lib, x)),
                bound=cost_bound_ms(*v2_cost(plan, k)))


def check_and_time_v2_minmax(name, case, plan, reduce, k, gen):
    """K7 on one shard plan at K: against its plain version bit for bit,
    timed beside ``scatter_reduce_`` over precomputed messages (values
    only) and the bound."""
    from isplib_tpu_torch.kernels import spmm_minmax as k7

    x = torch.randn(plan.num_cols, k, device=gen.device, generator=gen)
    sentinel = 2**31 - 1

    def kernel():
        return k7.spmm_minmax_v2(plan, x, reduce, sentinel)

    def plain():
        return k7.spmm_minmax_v2_plain(plan, x, reduce, sentinel)

    (out, arg), (pout, parg) = kernel(), plain()
    torch.cuda.synchronize()
    bad_bits = int((out.view(torch.int32) != pout.view(torch.int32)).sum())
    bad_args = int((arg != parg).sum())
    err = float((out - pout).abs().max())
    if bad_bits or bad_args:
        raise AssertionError(f"spmm_minmax_v2 {name} {case} {reduce} K={k}: "
                             f"{bad_bits} values differ in their bits, "
                             f"{bad_args} args differ (max err {err})")
    del out, arg, pout, parg
    s = plan.slots()
    keep = s["eid"] >= 0
    row, col, val = s["row"][keep], s["col"][keep], s["val"][keep]
    del s, keep
    msgs = val[:, None] * x.index_select(0, col)
    idx = row[:, None].expand(-1, k)
    lib_out = torch.zeros(plan.num_rows, k, device=x.device)
    lib_ms = cuda_ms(lambda: lib_out.scatter_reduce_(
        0, idx, msgs, "amax" if reduce == "max" else "amin",
        include_self=False))
    real = int(row.numel())
    del msgs, idx, lib_out, row, col, val
    wide = k > 64
    return dict(kernel="spmm_minmax", graph=name, case=case, reduce=reduce,
                k=k, max_abs_err=err, fill=plan.fill, nc=plan.nc,
                edges=real, walk=walk_line(plan.mm_sched, real),
                ms=cuda_ms(kernel, iters=10 if wide else 30),
                plain_ms=cuda_ms(plain, iters=2 if wide else 5, warmup=1),
                library_ms=lib_ms,
                bound=cost_bound_ms(*v2_cost(plan, k, out_bytes_per=8)))


def sharded_paths(graphs, cases, drive, train, check, unsharded, gen):
    """Phase 8: the row-sharded path on a 4-shard LocalMesh.  Partitions
    reddit-sim (version 5 with the max/min plans, and version 2) and
    density-rep (version 5); holds K8 and K7 against their plain versions
    on shard 0's local and halo plans (K8: forward and transpose) and
    times them; trains GCN on the
    version-5 route (K1/K2, both graphs) and on the version-2 route (K8),
    and GraphSAGE-max (K7), 30 epochs each, against the unsharded
    TiledGraph; then runs the one-shard partition through a one-rank
    GroupMesh over NCCL.  Appends the kernel cases to ``cases``; returns
    the launches of the version-5 GCN, version-2 GCN and GraphSAGE-max
    paths."""
    import torch.distributed as dist

    from isplib_tpu_torch import GCN, GraphSAGE, spmm
    from isplib_tpu_torch.dist import (GroupMesh, LocalMesh, set_mesh,
                                       spmm_sharded)
    from isplib_tpu_torch.kernels.spmm_hybrid import spmm_hybrid
    from isplib_tpu_torch.ops import reference

    rs, dr = graphs["reddit-sim"][0], graphs["density-rep"][0]
    sharded = {
        ("reddit-sim", 5): partition("reddit-sim", rs, {"version": 5}),
        ("reddit-sim", 2): partition("reddit-sim", rs,
                                     {"version": 2, "minmax": False}),
        ("density-rep", 5): partition("density-rep", dr,
                                      {"version": 5, "minmax": False})}

    # ---- K8 and K7 against their plain versions, and their times ---------
    sg2, sg5 = sharded[("reddit-sim", 2)], sharded[("reddit-sim", 5)]
    loc_f, loc_b, halo_f, halo_b = sg2.plans[0]
    for case, plan, ks in (("shard 0 loc", loc_f, (32, K_WIDE)),
                           ("shard 0 halo", halo_f, (32, K_WIDE)),
                           ("shard 0 loc bwd", loc_b, KS),
                           ("shard 0 halo bwd", halo_b, KS)):
        for k in ks:
            r = check_and_time_v2("reddit-sim", case, plan, k, gen)
            cases.append(r)
            log(f"spmm_v2 reddit-sim {case} K={k}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, bound "
                f"{r['bound'][0]:.4f} by {r['bound'][1]}), err "
                f"{r['max_abs_err']:.3g} <= {r['tol']:.3g} (fp32 plain "
                f"{r['plain_err']:.3g}); {r['edges']} edges in {r['nc']} "
                f"chunks, fill {r['fill']:.3f}")
    for case, plan in (("shard 0 loc", sg5.plans_mm[0][0]),
                       ("shard 0 halo", sg5.plans_mm[0][1])):
        for reduce in ("max", "min"):
            for k in MM_KS:
                r = check_and_time_v2_minmax("reddit-sim", case, plan,
                                             reduce, k, gen)
                cases.append(r)
                log(f"spmm_minmax reddit-sim {case} {reduce} K={k}: "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library "
                    f"values-only {r['library_ms']:.4f}, bound "
                    f"{r['bound'][0]:.4f} by {r['bound'][1]}); bit-exact; "
                    f"{r['edges']} edges in {r['nc']} chunks, fill "
                    f"{r['fill']:.3f}; {r['walk']}")

    # ---- the sharded paths -------------------------------------------------
    def gcn():
        return GCN(FEATURES, hidden=32, num_classes=CLASSES, seed=0)

    def sage():
        return GraphSAGE(FEATURES, hidden=32, num_classes=CLASSES,
                         aggr="max", seed=0)

    def epochs_vs_unsharded(label, runs, base):
        for name, _, res in runs:
            log(f"{name} {label}: sharded epoch "
                f"{res.train_time_avg * 1e3:.3f} ms against "
                f"{unsharded[(base, name)].train_time_avg * 1e3:.3f} ms "
                "unsharded")

    set_mesh(LocalMesh(4))
    try:
        for version, names, needs, launches_of in (
                (5, ("reddit-sim", "density-rep"), ("spmm_bsr",
                                                    "spmm_stream"), "v5"),
                (2, ("reddit-sim",), ("spmm_v2",), "v2")):
            label = f"sharded GCN v{version}"
            runs, launches = drive(
                f"{label} path", needs, lambda names=names, version=version,
                label=label: train(label, gcn, names, EPOCHS,
                                   lambda n: sharded[(n, version)]))
            # version 5's K2 rounds to bf16 in dense blocks that the shard
            # plans pick differently from the unsharded plan; version 2's
            # fp32 K8 differs from the unsharded K2 by that rounding alone
            check(label, runs, "nll", 2e-2 if version == 5 else 1e-3,
                  min_acc=0.7,
                  graph_of=lambda n, version=version: sharded[(n, version)])
            epochs_vs_unsharded(label, runs, "GCN")
            if version == 5:
                gcn_runs, v5_launches = runs, launches
            else:
                v2_launches = launches
        label = "sharded GraphSAGE-max"
        runs, mm_launches = drive(
            f"{label} path", ("spmm_minmax",),
            lambda: train(label, sage, ["reddit-sim"], EPOCHS,
                          lambda n: sharded[(n, 5)]))
        check(label, runs, "nll", 1e-4, min_acc=0.7,
              graph_of=lambda n: sharded[(n, 5)])
        epochs_vs_unsharded(label, runs, "GraphSAGE-max")
        sage_runs = runs

        # where a sharded epoch's time goes (reddit-sim)
        for label, version, (name, model, res) in (
                ("sharded GCN v5", 5, gcn_runs[0]),
                ("sharded GraphSAGE-max", 5, sage_runs[0])):
            prof_ms, busy_ms, per_kernel = profile_epochs(
                model, sharded[(name, version)], graphs[name][0])
            idle = 1.0 - busy_ms / (res.train_time_avg * 1e3)
            log(f"{name} {label} profile: device busy {busy_ms:.3f} ms per "
                f"epoch, idle {100 * idle:.1f}% of the "
                f"{res.train_time_avg * 1e3:.3f} ms epoch (profiled epoch "
                f"{prof_ms:.3f} ms); spmm_stream_kernel "
                f"{kernel_share(per_kernel, 'spmm_stream_kernel', busy_ms)}; "
                + "; ".join(f"{k[:48]} {v:.3f}"
                            for k, v in list(per_kernel.items())[:8]))
    finally:
        set_mesh(None)

    # ---- one rank over NCCL: the one-shard partition through GroupMesh ---
    _, g, tiled = graphs["reddit-sim"]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        # each rank partitions and keeps its own shard
        rank = [dist.get_rank()]
        one = partition("reddit-sim", rs, {"version": 5}, shards=1,
                        hold=rank)
        one_ref = partition("reddit-sim", rs, None, shards=1, hold=rank)
        mesh = GroupMesh()
        x = torch.randn(g.num_rows, 32, device=gen.device, generator=gen)

        def group_mesh_path():
            return (spmm_sharded(one, x, "sum", mesh),
                    spmm_sharded(one, x, "max", mesh),
                    spmm_sharded(one_ref, x, "sum", mesh))

        (s_sum, s_max, s_ref), _ = drive(
            "GroupMesh(1 rank, NCCL) path", ("spmm_bsr", "spmm_minmax"),
            group_mesh_path)
        check_near_plain("GroupMesh sum vs the unsharded hybrid SpMM", s_sum,
                         spmm_hybrid(tiled.fwd, x))
        check_near_plain("GroupMesh max vs the unsharded K3", s_max,
                         spmm(tiled, x, "max"))
        check_near_plain("GroupMesh reference route (NCCL all_to_all) vs "
                         "the reference path", s_ref,
                         reference.spmm_raw(g.row, g.col, g.value, g.deg, x,
                                            g.num_rows, "sum"))
        ms_sharded = cuda_ms(lambda: spmm_sharded(one, x, "sum", mesh))
        ms_plain = cuda_ms(lambda: spmm_hybrid(tiled.fwd, x))
        ms_sharded_mm = cuda_ms(lambda: spmm_sharded(one, x, "max", mesh))
        ms_plain_mm = cuda_ms(lambda: spmm(tiled, x, "max"))
        log(f"GroupMesh(1 rank, NCCL), reddit-sim K=32: sharded sum "
            f"{ms_sharded:.4f} ms against the unsharded hybrid SpMM "
            f"{ms_plain:.4f} ms (overhead {ms_sharded - ms_plain:.4f} ms); "
            f"sharded max (K7) {ms_sharded_mm:.4f} ms against K3 "
            f"{ms_plain_mm:.4f} ms")
    finally:
        dist.destroy_process_group()
    return v5_launches, v2_launches, mm_launches


def plan_bytes(obj) -> int:
    """Device bytes of a plan, nested plans included."""
    if obj is None:
        return 0
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(plan_bytes(v) for v in vars(obj).values()
               if v is None or isinstance(v, torch.Tensor) or hasattr(
                   v, "__dataclass_fields__"))


def v3_members(plan):
    """The real (non-pad) members of a BSRPlan: their row blocks and block
    columns (a cell's real members have strictly increasing rb_locals, its
    group pads come last with rb_local 0)."""
    g, n = plan.g, plan.nb
    groups = torch.arange(n // g, device=plan.device, dtype=torch.int32)
    cell = (torch.searchsorted(plan.cell_starts[:-1].contiguous(), groups,
                               right=True).long() - 1).repeat_interleave(g)
    rbl = plan.rb_locals.long()
    first = plan.cell_starts.long()[cell] * g == torch.arange(
        n, device=plan.device)
    prev = torch.cat([rbl.new_full((1,), -1), rbl[:-1]])
    real = first | (rbl > prev)
    rblock = (cell // plan.n_bc) * plan.nrb_s + rbl
    return rblock[real], (cell % plan.n_bc)[real]


def v3_dense_csr(plan, graph):
    """The edges of a BSRPlan's dense blocks as a CSR tensor (fp32 values),
    the library yardstick of K9."""
    rblock, bcol = v3_members(plan)
    n = graph.nnz
    row, col = graph.row[:n].long(), graph.col[:n].long()
    n_bc = plan.n_bc
    is_dense = torch.isin((row // 128) * n_bc + col // 128,
                          rblock * n_bc + bcol)
    rowptr = torch.zeros(graph.num_rows + 1, dtype=torch.long,
                         device=row.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row[is_dense],
                                             minlength=graph.num_rows), 0)
    return (csr(rowptr, col[is_dense], graph.value[:n][is_dense],
                graph.shape), rblock, bcol)


def check_and_time_v3(name, direction, plan, graph, k, gen):
    """K9 on one plan at K: against its plain version (same rounding, sum
    order only: 1e-4·max|plain|), timed beside ``torch.sparse.mm`` of the
    dense blocks' edges and the bound (the real members' bf16 blocks, the x
    tiles of their block columns, the rows they write; 2·128²·K operations
    a member at the bf16 tensor-core rate)."""
    from isplib_tpu_torch.kernels import spmm_bsr_v3 as k9

    x = torch.randn(plan.num_cols, k, device=gen.device, generator=gen)
    err, tol = check_near_plain(f"spmm_bsr_v3 {name} {direction} K={k}",
                                k9.spmm_bsr_v3(plan, x),
                                k9.spmm_bsr_v3_plain(plan, x))
    lib, rblock, bcol = v3_dense_csr(plan, graph)
    members = int(rblock.numel())
    x_rows = min(used(bcol) * 128, plan.num_cols)
    out_rows = min(used(rblock) * 128, plan.num_rows)
    wide = k > 64
    pieces = plan.sched.pieces
    return dict(kernel="spmm_bsr_v3", graph=name, direction=direction, k=k,
                max_abs_err=err, tol=tol, members=members, nb=plan.nb,
                pieces=int(pieces.shape[0]),
                split=int(pieces[:, 3].sum()),
                ms=cuda_ms(lambda: k9.spmm_bsr_v3(plan, x)),
                plain_ms=cuda_ms(lambda: k9.spmm_bsr_v3_plain(plan, x),
                                 iters=2 if wide else 5, warmup=1),
                library_ms=cuda_ms(lambda: torch.sparse.mm(lib, x)),
                bound=bound_ms(
                    members * 128 * 128 * 2 + (plan.nb + plan.n_cells + 1) * 4
                    + x_rows * k * 4 + out_rows * k * 4,
                    2.0 * members * 128 * 128 * k, BF16_TENSOR_FLOPS))


def check_and_time_v1(name, direction, plan, graph, k, gen):
    """K10 on one plan at K: against its plain version evaluated in
    float64 (as K8's), timed beside ``torch.sparse.mm`` of the same edges
    and the bound (12 B a real edge, the chunk tables, the x rows read, the
    output)."""
    from isplib_tpu_torch.kernels import spmm_rowblock as k10
    from isplib_tpu_torch.sparse.tiling import SEG_SLOTS

    x = torch.randn(plan.num_cols, k, device=gen.device, generator=gen)
    want = k10.spmm_rowblock_plain(plan, x.double())
    err, tol = check_near_plain(f"spmm_rowblock {name} {direction} K={k}",
                                k10.spmm_rowblock(plan, x), want)
    plain_err = float((k10.spmm_rowblock_plain(plan, x) - want).abs().max())
    del want
    n = graph.nnz
    lib = csr(graph.rowptr, graph.col[:n], graph.value[:n], graph.shape)
    wide = k > 64
    s = plan.sched
    per_row = s.row_ptr.diff()
    return dict(kernel="spmm_rowblock", graph=name, direction=direction, k=k,
                max_abs_err=err, tol=tol, plain_err=plain_err, nc=plan.nc,
                fill=plan.fill,
                nseg=s.nseg, split_rows=int((per_row > SEG_SLOTS).sum()),
                ms=cuda_ms(lambda: k10.spmm_rowblock(plan, x)),
                plain_ms=cuda_ms(lambda: k10.spmm_rowblock_plain(plan, x),
                                 iters=2 if wide else 5, warmup=1),
                library_ms=cuda_ms(lambda: torch.sparse.mm(lib, x)),
                bound=bound_ms(
                    n * 12 + plan.nc * 8 + (plan.nrb + 1) * 4
                    + used(graph.col[:n]) * k * 4 + plan.num_rows * k * 4,
                    2.0 * n * k, FP32_FLOPS))


def same_plans(a, b) -> bool:
    """Two plan trees equal: types, integers, tensors bit for bit."""
    import dataclasses
    if type(a) is not type(b):
        return False
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    if dataclasses.is_dataclass(a):
        return all(same_plans(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def tuner_paths(graphs, cases, drive, train, check, gen):
    """Phase 9: every DEFAULT_CONFIGS entry built (A and Aᵀ) and held
    against the reference path on both graphs, and ``tune_spmm`` over those
    builds; K9, K10 and K8 (density-rep's full version-2 plan and
    version-3 residual) against their plain versions and timed; the
    forced-split paths of K9, K2, K10 and K8; ``auto_tile``
    of a fresh graph from both caches and 10 GCN epochs on it; GCN through
    versions 3, 1 and 2 on density-rep.  Appends the kernel cases to
    ``cases``; returns the launches of the version-3, -1 and -2 paths."""
    import contextlib
    import dataclasses

    from isplib_tpu_torch import GCN, graph_from_arrays
    from isplib_tpu_torch.kernels.spmm_hybrid import run_plan
    from isplib_tpu_torch.ops import reference
    from isplib_tpu_torch.sparse import plan_cache
    from isplib_tpu_torch.sparse.tiling import (auto_tile,
                                                build_tiling_from_numpy,
                                                host_arrays)
    from isplib_tpu_torch.tune import autotune

    def cfg_tag(cfg):
        return " ".join(f"{f}={v}" for f, v in cfg.items())

    t_phase = time.perf_counter()

    # ---- every configuration, built once (A and Aᵀ) and held against the
    # reference; the tuner times these builds and persists its winner's ----
    kept, build_s, winners = {}, {}, {}
    for name, (_, g, _) in graphs.items():
        arrays = host_arrays(g)
        gt = g.transpose()
        x = torch.randn(g.num_cols, 32, device=gen.device, generator=gen)
        refs = {d: reference.spmm_raw(gg.row, gg.col, gg.value, gg.deg, x,
                                      gg.num_rows, "sum")
                for d, gg in (("fwd", g), ("bwd", gt))}
        built = []
        for i, cfg in enumerate(autotune.DEFAULT_CONFIGS):
            t0 = time.perf_counter()
            tg = build_tiling_from_numpy(g, arrays, k=32, **cfg)
            torch.cuda.synchronize()
            build_s[(name, i)] = time.perf_counter() - t0
            bf16 = cfg["version"] in (5, 3)
            errs = []
            for d, plan in (("fwd", tg.fwd), ("bwd", tg.bwd)):
                out, ref = run_plan(plan, x), refs[d]
                scale = float(ref.abs().max())
                err = float((out - ref).abs().max())
                ok = bool(torch.isfinite(out).all()) and (
                    torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale)
                    if bf16 else err <= 1e-4 * scale)
                if not ok:
                    raise AssertionError(f"{name} {cfg_tag(cfg)} {d}: max err "
                                         f"{err} (max |ref| {scale})")
                errs.append(err / scale)
            log(f"config {name:11s} {cfg_tag(cfg)}: built A and Aᵀ in "
                f"{build_s[(name, i)]:.2f}s, fwd plan "
                f"{plan_bytes(tg.fwd) / 2**20:.1f} MiB fill "
                f"{tg.fwd.fill:.3f}, bwd {plan_bytes(tg.bwd) / 2**20:.1f} "
                f"MiB; err/max|ref| fwd {errs[0]:.3g}, bwd {errs[1]:.3g}")
            if cfg["version"] in (3, 2, 1) and (
                    name == "density-rep" or cfg["version"] == 1):
                kept.setdefault((name, cfg["version"]), tg)
            built.append(tg)
            del tg
        del refs

        t0 = time.perf_counter()
        with contextlib.redirect_stderr(sys.stdout):
            best, tiled = autotune.tune_spmm(g, arrays, k=32,
                                             iters=TUNE_ITERS, built=built)
        torch.cuda.synchronize()
        log(f"tune_spmm {name}: {time.perf_counter() - t0:.1f}s (timing the "
            f"checked builds, saving the winner's plans); winner "
            f"{best['backend']} "
            + cfg_tag({f: v for f, v in best.items()
                       if f not in ("backend", "seconds", "edges_per_s")})
            + f", {best['seconds'] * 1e3:.4f} ms, "
            f"{best['edges_per_s'] / 1e9:.3f} Gedges/s")
        winners[name] = (best, tiled)
        del built

    # ---- K9 and K10 against their plain versions, and their times --------
    _, gd, _ = graphs["density-rep"]
    v3 = kept[("density-rep", 3)]
    for direction, plan, graph in (("fwd", v3.fwd.bsr, gd),
                                   ("bwd", v3.bwd.bsr, gd.transpose())):
        for k in MM_KS:
            r = check_and_time_v3("density-rep", direction, plan, graph, k,
                                  gen)
            cases.append(r)
            log(f"spmm_bsr_v3  density-rep {direction} K={k}: {r['ms']:.4f} "
                f"ms (plain {r['plain_ms']:.3f}, library "
                f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
                f"{r['bound'][1]}), err {r['max_abs_err']:.3g} <= "
                f"{r['tol']:.3g}; {r['members']} real members of {r['nb']} "
                f"in {r['pieces']} pieces, {r['split']} of split row blocks")
    for name, (_, g, _) in graphs.items():
        v1 = kept[(name, 1)]
        for direction, plan, graph in (("fwd", v1.fwd, g),
                                       ("bwd", v1.bwd, g.transpose())):
            for k in MM_KS:
                r = check_and_time_v1(name, direction, plan, graph, k, gen)
                cases.append(r)
                log(f"spmm_rowblock {name:11s} {direction} K={k}: "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library "
                    f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
                    f"{r['bound'][1]}), err {r['max_abs_err']:.3g} <= "
                    f"{r['tol']:.3g} (fp32 plain {r['plain_err']:.3g}); "
                    f"{r['nc']} chunks, fill {r['fill']:.3f}, "
                    f"{r['nseg']} items, {r['split_rows']} split rows")

    # ---- K8 on density-rep's full plans: the version-2 plan (256/512/512)
    # and the version-3 residual (256/128/512 at threshold 64) ------------
    v2 = kept[("density-rep", 2)]
    for case, direction, plan in (
            ("v2", "fwd", v2.fwd), ("v2", "bwd", v2.bwd),
            ("v3 residual", "fwd", v3.fwd.residual),
            ("v3 residual", "bwd", v3.bwd.residual)):
        for k in MM_KS:
            r = check_and_time_v2("density-rep", f"{case} {direction}", plan,
                                  k, gen)
            cases.append(r)
            log(f"spmm_v2 density-rep {case} {direction} K={k}: "
                f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library "
                f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
                f"{r['bound'][1]}), err {r['max_abs_err']:.3g} <= "
                f"{r['tol']:.3g} (fp32 plain {r['plain_err']:.3g}); "
                f"{r['edges']} edges in {r['nc']} chunks, fill "
                f"{r['fill']:.3f}, {r['nseg']} items")

    # ---- the split paths at full size: density-rep's plans with their hub
    # row blocks cut into pieces of 4 members (K9) or blocks (K2) and their
    # rows into items of 32 slots (K10, K8), so most outputs are added by
    # several CTAs or warps; K8 also adds into an output it is given ------
    from isplib_tpu_torch.kernels import spmm_bsr as k2
    from isplib_tpu_torch.kernels import spmm_bsr_v3 as k9
    from isplib_tpu_torch.kernels import spmm_rowblock as k10
    from isplib_tpu_torch.kernels import spmm_v2 as k8
    from isplib_tpu_torch.sparse.tiling import derive_row_schedule
    from isplib_tpu_torch.sparse.tiling_v2 import derive_v2_schedule
    from isplib_tpu_torch.sparse.tiling_v3 import derive_bsr_schedule
    from isplib_tpu_torch.sparse.tiling_v5 import derive_block_schedule
    v1, v5 = kept[("density-rep", 1)], graphs["density-rep"][2]
    for direction, p3, p1, p5, p2 in (
            ("fwd", v3.fwd.bsr, v1.fwd, v5.fwd, v2.fwd),
            ("bwd", v3.bwd.bsr, v1.bwd, v5.bwd, v2.bwd)):
        p3 = dataclasses.replace(p3, sched=derive_bsr_schedule(
            p3, piece_members=4))
        p1 = dataclasses.replace(p1, sched=derive_row_schedule(
            p1, seg_slots=32))
        p5 = dataclasses.replace(p5, sched=derive_block_schedule(
            p5, piece_blocks=4))
        p2 = dataclasses.replace(p2, sched=derive_v2_schedule(
            p2, seg_slots=32))
        split3 = int(p3.sched.pieces[:, 3].sum())
        split1 = int((p1.sched.row_ptr.diff() > 32).sum())
        split5 = int(p5.sched.pieces[:, 3].sum())
        split2 = int((p2.sched.row_ptr.diff() > 32).sum())
        if not (split3 and split1 and split5 and split2):
            raise AssertionError(
                f"density-rep {direction}: no split pieces ({split3}, "
                f"{split5}) or rows ({split1}, {split2})")
        for k in MM_KS:
            x = torch.randn(p3.num_cols, k, device=gen.device, generator=gen)
            base = torch.randn(p2.num_rows, k, device=gen.device,
                               generator=gen)
            e3, t3 = check_near_plain(
                f"spmm_bsr_v3 density-rep {direction} K={k}, pieces of 4",
                k9.spmm_bsr_v3(p3, x), k9.spmm_bsr_v3_plain(p3, x))
            e1, t1 = check_near_plain(
                f"spmm_rowblock density-rep {direction} K={k}, items of 32",
                k10.spmm_rowblock(p1, x), k10.spmm_rowblock_plain(p1, x))
            e5, t5 = check_near_plain(
                f"spmm_bsr density-rep {direction} K={k}, pieces of 4",
                k2.spmm_bsr(p5, x), k2.spmm_bsr_plain(p5, x))
            want2 = k8.spmm_v2_plain(p2, x)
            e2, t2 = check_near_plain(
                f"spmm_v2 density-rep {direction} K={k}, items of 32",
                k8.spmm_v2(p2, x), want2)
            e2a, t2a = check_near_plain(
                f"spmm_v2 density-rep {direction} K={k}, items of 32, added",
                k8.spmm_v2(p2, x, base.clone()), want2 + base)
            for kname, err in (("spmm_bsr_v3", e3), ("spmm_rowblock", e1),
                               ("spmm_bsr", e5), ("spmm_v2", max(e2, e2a))):
                cases.append(dict(kernel=kname, graph="density-rep",
                                  direction=direction, case="split", k=k,
                                  max_abs_err=err))
            log(f"split density-rep {direction} K={k}: spmm_bsr_v3 with "
                f"{p3.sched.n_pieces} pieces of <= 4 members ({split3} of "
                f"split row blocks), err {e3:.3g} <= {t3:.3g}; spmm_rowblock "
                f"with {p1.sched.nseg} items of <= 32 slots ({split1} split "
                f"rows), err {e1:.3g} <= {t1:.3g}; spmm_bsr with "
                f"{p5.sched.n_pieces} pieces of <= 4 blocks ({split5} of "
                f"split block-rows), err {e5:.3g} <= {t5:.3g}; spmm_v2 with "
                f"{p2.sched.nseg} items of <= 32 slots ({split2} split rows), "
                f"err {e2:.3g} <= {t2:.3g}, added {e2a:.3g} <= {t2a:.3g}")
            del x, base, want2
        del p3, p1, p5, p2

    # ---- auto_tile of a fresh graph takes the winner from both caches -----
    for name, (arrays, g, _) in graphs.items():
        best, tiled = winners.pop(name)
        key = autotune.signature_of(g, 32)
        if autotune.lookup(key) != best:
            raise AssertionError(f"{name}: the tune cache lost the winner")
        if best["backend"] != "kernels":
            raise AssertionError(f"{name}: the reference path won the sweep")
        files = [f for f in os.listdir(plan_cache.default_cache_dir())
                 if f.startswith(f"plan_{key}_")]
        fresh = graph_from_arrays(arrays, "cuda")
        t0 = time.perf_counter()
        loaded = auto_tile(fresh, k=32)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        i = next(i for i, c in enumerate(autotune.DEFAULT_CONFIGS)
                 if all(best.get(f) == v for f, v in c.items()))
        if not all(same_plans(getattr(loaded, f), getattr(tiled, f))
                   for f in ("fwd", "bwd", "fwd_mm", "bwd_mm")):
            raise AssertionError(f"{name}: auto_tile's plans differ from the "
                                 "tuned winner's")
        log(f"auto_tile {name} (fresh graph, k=32): the tuned config's plans "
            f"from the plan cache ({len(files)} file(s) under the "
            f"signature), equal to the winner's, in {load_s:.2f}s against "
            f"{build_s[(name, i)]:.2f}s to build them")
        ver = best["version"]
        if ver == 5:
            needs = ("spmm_bsr",) if loaded.fwd.nb else ("spmm_stream",)
        else:
            needs = {4: ("spmm_stream",), 3: ("spmm_bsr_v3",),
                     2: ("spmm_v2",), 1: ("spmm_rowblock",)}[ver]
        label = f"tuned GCN (version {ver})"
        runs, _ = drive(f"{label} path on {name}", needs, lambda: train(
            label, lambda: GCN(FEATURES, hidden=32, num_classes=CLASSES,
                               seed=0), [name], SHORT_EPOCHS,
            lambda n, t=loaded: t))
        check(label, runs, "nll", 2e-2 if ver in (5, 3) else 1e-4,
              tiled_of=lambda n, t=loaded: t)
        del loaded, tiled, fresh

    # ---- GCN through versions 3, 1 and 2 on density-rep -------------------
    launches = {}
    for ver, needs in ((3, ("spmm_bsr_v3", "spmm_v2")),
                       (1, ("spmm_rowblock",)), (2, ("spmm_v2",))):
        t = kept[("density-rep", ver)]
        label = f"GCN version {ver}"
        runs, launches[ver] = drive(f"{label} path", needs, lambda t=t: train(
            label, lambda: GCN(FEATURES, hidden=32, num_classes=CLASSES,
                               seed=0), ["density-rep"], SHORT_EPOCHS,
            lambda n, t=t: t))
        check(label, runs, "nll", 2e-2 if ver == 3 else 1e-4,
              tiled_of=lambda n, t=t: t)
        # the device's share, which host-bound epoch times hide
        _, model, res = runs[0]
        _, busy_ms, per_kernel = profile_epochs(
            model, t, graphs["density-rep"][0])
        epoch_ms = res.train_time_avg * 1e3
        log(f"density-rep {label} profile: device busy {busy_ms:.3f} ms per "
            f"epoch, idle {100 * (1 - busy_ms / epoch_ms):.1f}% of the "
            f"{epoch_ms:.3f} ms epoch; "
            + "; ".join(f"{kn[:48]} {v:.3f}"
                        for kn, v in list(per_kernel.items())[:6]))
    log(f"phase 9 (tuner and plan versions): "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def spun(fn):
    """``fn()`` in a profiled window, after ``LEAD_KERNELS`` small kernels
    and between two spins of the card (``torch.cuda._sleep``), so that the
    window starts and ends with the card busy.  On the H100 the profiler
    drops the first 4 or 5 device records of a session as out of its
    window (Kineto's "Out-of-range" count, whatever their times: PR 12's
    probes), so the lead kernels are the records it loses."""
    lead = torch.zeros(1, device="cuda")
    for _ in range(LEAD_KERNELS):
        lead.add_(1.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    out = fn()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    return out


def complete_capture(call, capture, launched_by: dict, tries: int = 10,
                     whole: bool = True):
    """``capture()`` runs ``call`` under the profiler (:func:`spun`) and
    returns ``(result, the kernel names it recorded, one per kernel
    event)``; each attempt runs ``call`` unprofiled first.  torch.profiler
    can drop device records (seen on an H100: a profile of a few kernels
    that records none or some of them; :func:`spun` opens each window with
    the records it drops), so a capture is used only when it holds the
    kernels this script counts itself: with ``whole``, one recorded event
    per launch of each ``{name substring: kernel module}`` of
    ``launched_by`` (its ``LAUNCHES``), else at least one.  Returns
    ``(result, attempts)`` of the first such capture of ``tries``."""
    for attempt in range(1, tries + 1):
        call()
        torch.cuda.synchronize()
        before = {n: m.LAUNCHES for n, m in launched_by.items()}
        result, names = capture()
        launched = {n: m.LAUNCHES - before[n] for n, m in launched_by.items()}
        seen = {n: sum(n in kn for kn in names) for n in launched_by}
        if all(launched.values()) and (seen == launched if whole else
                                       all(seen.values())):
            return result, attempt
        log(f"profiler capture {attempt}: recorded {seen} of the launches "
            f"{launched}; capturing again")
    raise AssertionError(f"no complete profiler capture in {tries} tries")


def memcpy_count(fn, launched_by: dict):
    """``((copies, counts by name), attempts)``: the host<->device copies
    (``Memcpy DtoH`` / ``HtoD`` events) of one call of ``fn`` under
    ``torch.profiler``, from a capture complete for ``launched_by``
    (:func:`complete_capture`)."""
    from torch.profiler import ProfilerActivity, profile

    def capture():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spun(fn)
        copies, kernels = {}, []
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "Memcpy DtoH" in ev.name or "Memcpy HtoD" in ev.name:
                copies[ev.name] = copies.get(ev.name, 0) + 1
            else:
                kernels.append(ev.name)
        return (sum(copies.values()), copies), kernels

    return complete_capture(fn, capture, launched_by)


def interop_paths(graphs, drive, dataset, gen):
    """Phase 10: the torch/PyG bridge and the training tools on the
    density-representative graph (both K1 and K2 carry edges there) and
    reddit-sim, at GCN's widths.  Parts a-g and i run on a fresh tune
    cache, so that ``auto_tile`` takes the occupancy rule (phase 9 recorded
    winners for these graphs); part h on phase 9's caches."""
    import types

    from isplib_tpu_torch import (GCN, findbestk, graph_from_arrays,
                                  make_train_step, spmm,
                                  train_node_classifier)
    from isplib_tpu_torch.interop import (clear_cache, iSpLibPlugin,
                                          isplib_autotune, torch_bridge,
                                          torch_spmm)
    from isplib_tpu_torch.interop.torch_baseline import train_torch_baseline
    from isplib_tpu_torch.kernels import spmm_bsr, spmm_stream
    from isplib_tpu_torch.sparse import tiling
    from isplib_tpu_torch.train import restore_checkpoint, save_checkpoint
    from isplib_tpu_torch.tune import autotune
    from isplib_tpu_torch.utils import Timer, trace

    t_phase = time.perf_counter()
    arrays_d, g_d, tiled_d = graphs["density-rep"]
    arrays_r, g_r, tiled_r = graphs["reddit-sim"]
    scratch = tempfile.mkdtemp(prefix="isplib_tpu_torch_phase10_")
    saved_tune = autotune._CACHE_PATH, autotune._memory_cache
    autotune._CACHE_PATH = os.path.join(scratch, "tune.json")
    autotune._memory_cache = None

    # every plan build of auto_tile and every graph build of the bridge,
    # with its seconds and device bytes
    builds, bridge_builds = [], []
    build_tiling, from_scipy = tiling.build_tiling, torch_bridge.from_scipy

    def counted_tiling(g, **kw):
        t0 = time.perf_counter()
        out = build_tiling(g, **kw)
        torch.cuda.synchronize()
        builds.append(dict(k=kw.get("k"), nnz=g.nnz,
                           s=time.perf_counter() - t0,
                           mib=sum(plan_bytes(getattr(out, f)) for f in (
                               "fwd", "bwd", "fwd_mm", "bwd_mm")) / 2**20,
                           cfg={f: v for f, v in kw.items()
                                if f not in ("k", "cache_tag")}))
        return out

    def counted_bridge(*a, **kw):
        t0 = time.perf_counter()
        out = from_scipy(*a, **kw)
        torch.cuda.synchronize()
        bridge_builds.append(time.perf_counter() - t0)
        return out

    tiling.build_tiling = counted_tiling
    torch_bridge.from_scipy = counted_bridge
    x_d = torch.from_numpy(arrays_d["x"]).cuda()
    y_d = torch.from_numpy(arrays_d["y"]).cuda()
    mask_d = torch.from_numpy(arrays_d["train_mask"]).cuda()
    try:
        # ---- a. pt.spmm on a plain CUDA CSRGraph tiles it and runs K1+K2
        fresh = graph_from_arrays(arrays_d, "cuda")
        x = torch.randn(fresh.num_cols, 32, device="cuda", generator=gen)
        out, _ = drive("plain CSRGraph spmm path (density-rep, K=32)",
                       ("spmm_bsr", "spmm_stream"), lambda: spmm(fresh, x))
        spmm(fresh, x)
        if len(builds) != 1:
            raise AssertionError(f"auto_tile built {len(builds)} times over "
                                 "two calls on one graph")
        ref = spmm(fresh, x, backend="reference")
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        if not (torch.isfinite(out).all() and torch.allclose(
                out, ref, rtol=2e-2, atol=2e-2 * scale)):
            raise AssertionError(f"spmm of a plain CSRGraph: max err {err} "
                                 f"(max |ref| {scale})")
        tiled_f = tiling.auto_tile(fresh, 32)
        ms_csr = cuda_ms(lambda: spmm(fresh, x))
        ms_tiled = cuda_ms(lambda: spmm(tiled_f, x))
        b = builds[0]
        log(f"interop a: spmm(CSRGraph density-rep, K=32) tiled once by "
            f"auto_tile (version 5 {b['cfg']}, {b['s']:.2f}s, "
            f"{b['mib']:.1f} MiB of plans), a second call built nothing; "
            f"err {err:.3g} vs the fp32 reference (max |ref| {scale:.3g}, "
            f"bf16 contract 2e-2); {ms_csr:.4f} ms a call against "
            f"{ms_tiled:.4f} ms for spmm(tiled) on the same plans")
        del fresh, tiled_f, out, ref

        # ---- b. the reference's A/B: pt1 GCN, cuSPARSE against the patch
        ds = dataset("density-rep", g_d)
        orig_mm = torch.sparse.mm

        def baseline():
            return train_torch_baseline("gcn", ds, epochs=SHORT_EPOCHS,
                                        hidden=32, device="cuda")

        plain, plain_launches = drive("pt1 GCN path, unpatched", (),
                                      baseline)
        if plain_launches["spmm_bsr"] or plain_launches["spmm_stream"]:
            raise AssertionError("the unpatched pt1 run launched K1/K2")
        builds.clear()
        patched, _ = drive(
            "pt1 GCN path under isplib_autotune", ("spmm_bsr", "spmm_stream"),
            isplib_autotune(baseline))
        if torch.sparse.mm is not orig_mm or iSpLibPlugin.backup:
            raise AssertionError("torch.sparse.mm was not restored")
        if len(bridge_builds) != 1:
            raise AssertionError(f"the bridge built {len(bridge_builds)} "
                                 "graphs of one adjacency")
        clear_cache()
        for label, res in (("unpatched", plain), ("patched", patched)):
            if not (np.all(np.isfinite(res.losses))
                    and res.losses[-1] < res.losses[0]):
                raise AssertionError(f"pt1 GCN {label}: losses {res.losses}")
        l_plain, l_patched = plain.losses[-1], patched.losses[-1]
        if not abs(l_patched - l_plain) <= 2e-2 * abs(l_plain):
            raise AssertionError(f"pt1 GCN: patched final loss {l_patched} "
                                 f"vs unpatched {l_plain} (rtol 2e-2)")
        # the v5 plans do not depend on k: one build serves both layers
        if [b["k"] for b in builds] != [32]:
            raise AssertionError(f"the patched GCN tiled {builds}")
        for label, res in (("unpatched (cuSPARSE)", plain),
                           ("patched (K1+K2)", patched)):
            log(f"density-rep pt1 GCN(602-32-41) {label}, {SHORT_EPOCHS} "
                f"epochs:\n{res.table()}")
        log(f"interop b: pt1 GCN epoch {patched.train_time_avg * 1e3:.3f} ms "
            f"patched against {plain.train_time_avg * 1e3:.3f} ms unpatched "
            f"(ratio {patched.train_time_avg / plain.train_time_avg:.3f}); "
            f"final loss {l_patched:.6f} vs {l_plain:.6f}; the bridge built "
            f"its graph once in {bridge_builds[-1]:.2f}s; auto_tile built "
            + "; ".join(f"K={b['k']} version 5 {b['cfg']} {b['s']:.2f}s "
                        f"{b['mib']:.1f} MiB" for b in builds)
            + " once for both layers (K = 32 and 41)")

        # ---- c. a fake torch_sparse: matmul(adj, x, reduce="max") runs K3
        n = g_r.nnz

        class SparseTensor:
            """``torch_sparse.SparseTensor`` as the bridge reads it."""

            def __init__(self):
                self.parts = (g_r.rowptr.long(), g_r.col[:n].long(),
                              g_r.value[:n])

            def csr(self):
                return self.parts

            def sparse_sizes(self):
                return g_r.shape

        def unpatched_matmul(*a, **kw):
            raise AssertionError("the unpatched torch_sparse.matmul ran")

        fake = types.ModuleType("torch_sparse")
        fake.matmul, fake.SparseTensor = unpatched_matmul, SparseTensor
        sys.modules["torch_sparse"] = fake
        adj = SparseTensor()
        xv = torch.randn(g_r.num_cols, 32, device="cuda", generator=gen)
        w = torch.randn(g_r.num_rows, 32, device="cuda", generator=gen)
        # index_add_'s deterministic form, so both gradients sum in one order
        torch.use_deterministic_algorithms(True, warn_only=True)
        iSpLibPlugin.patch_pyg()
        try:
            xb = xv.clone().requires_grad_(True)
            got, _ = drive("patched torch_sparse.matmul max path (reddit-sim)",
                           ("spmm_minmax_v4",),
                           lambda: fake.matmul(adj, xb, reduce="max"))
            (got * w).sum().backward()
            xt = xv.clone().requires_grad_(True)
            want = spmm(tiled_r, xt, "max")
            (want * w).sum().backward()
        finally:
            iSpLibPlugin.unpatch_pyg()
            torch.use_deterministic_algorithms(False)
            sys.modules.pop("torch_sparse")
        if fake.matmul is not unpatched_matmul:
            raise AssertionError("torch_sparse.matmul was not restored")
        if not (torch.equal(got, want) and torch.equal(xb.grad, xt.grad)):
            raise AssertionError("torch_sparse.matmul max differs from "
                                 "spmm(tiled, x, 'max')")
        log("interop c: patched torch_sparse.matmul(SparseTensor reddit-sim, "
            "x, reduce='max') at K=32: out and grad_x bit for bit equal to "
            "spmm(tiled, x, 'max')")

        # ---- d. no host copy per call: a cache-hit forward + backward of
        # torch_spmm against the same direct spmm(tiled, x)
        bridged, _ = torch_bridge._graph_cache[next(iter(
            torch_bridge._graph_cache))]
        tiled_b = tiling.auto_tile(bridged, 32)
        n_graphs = len(torch_bridge._graph_cache)

        def via_bridge():
            xq = xv.clone().requires_grad_(True)
            (torch_spmm(adj, xq) * w).sum().backward()

        def direct():
            xq = xv.clone().requires_grad_(True)
            (spmm(tiled_b, xq) * w).sum().backward()

        k2 = {"bsrwalk::walk_kernel": spmm_bsr}
        (c_bridge, n_bridge), t_bridge = memcpy_count(via_bridge, k2)
        (c_direct, n_direct), t_direct = memcpy_count(direct, k2)
        if len(torch_bridge._graph_cache) != n_graphs or len(builds) != 2:
            raise AssertionError("the cache-hit call built a graph or plan")
        if c_bridge > c_direct:
            raise AssertionError(f"the bridge copies {n_bridge} against the "
                                 f"direct call's {n_direct}")
        ms_bridge = cuda_ms(lambda: torch_spmm(adj, xv))
        ms_direct = cuda_ms(lambda: spmm(tiled_b, xv))
        log(f"interop d: host<->device copies in one forward + backward: "
            f"torch_spmm (cache hit) {c_bridge} {n_bridge}, direct "
            f"spmm(tiled, x) {c_direct} {n_direct} (complete captures, "
            f"attempts {t_bridge} and {t_direct}); forward "
            f"{ms_bridge:.4f} ms through the bridge against "
            f"{ms_direct:.4f} ms direct (reddit-sim, K=32, sum)")
        del bridged, tiled_b, got, want, xb, xt
        clear_cache()

        # ---- e. make_train_step: 10 steps against train_node_classifier
        def gcn():
            return GCN(FEATURES, hidden=32, num_classes=CLASSES, seed=0)

        def adam(m):
            return torch.optim.Adam(m.parameters(), lr=0.01,
                                    weight_decay=5e-4)

        res = train_node_classifier(gcn(), dataset("density-rep"),
                                    epochs=SHORT_EPOCHS, seed=0)

        def stepped(count):
            m = gcn()
            opt = adam(m)
            step = make_train_step(m, opt, tiled_d)
            g = torch.Generator(device="cuda").manual_seed(0)
            return m, opt, step, g, [step(x_d, y_d, mask_d, g)[0]
                                     for _ in range(count)]

        (_, _, _, _, losses), _ = drive(
            "make_train_step GCN path (density-rep)",
            ("spmm_bsr", "spmm_stream"), lambda: stepped(SHORT_EPOCHS))
        steps = torch.stack(losses).tolist()
        if not np.allclose(steps, res.losses, rtol=1e-4, atol=0):
            raise AssertionError(f"make_train_step losses {steps} vs "
                                 f"train_node_classifier's {res.losses}")
        log(f"interop e: make_train_step, {SHORT_EPOCHS} steps, losses "
            f"{steps[0]:.6f} -> {steps[-1]:.6f}, within 1e-4 of "
            f"train_node_classifier's {res.losses[0]:.6f} -> "
            f"{res.losses[-1]:.6f}")

        # ---- f. checkpoints: 5 steps, save, restore, 5 more
        half = SHORT_EPOCHS // 2
        m, opt, _, g, first = stepped(half)
        ckdir = os.path.join(scratch, "ckpt")
        t0 = time.perf_counter()
        save_checkpoint(ckdir, half, m.state_dict(), opt.state_dict(),
                        extra={"generator": g.get_state()})
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(ckdir, f"step_{half}.pt"))
        t0 = time.perf_counter()
        ck = restore_checkpoint(ckdir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        m2 = gcn()
        opt2 = adam(m2)
        m2.load_state_dict(ck["params"])
        opt2.load_state_dict(ck["opt_state"])
        g2 = torch.Generator(device="cuda")
        g2.set_state(ck["extra"]["generator"].cpu())
        step2 = make_train_step(m2, opt2, tiled_d)
        resumed = torch.stack(first + [step2(x_d, y_d, mask_d, g2)[0]
                                       for _ in range(half)]).tolist()
        if not np.allclose(resumed, steps, rtol=1e-4, atol=0):
            raise AssertionError(f"resumed losses {resumed} vs "
                                 f"uninterrupted {steps}")
        log(f"interop f: checkpoint of GCN + Adam after {half} steps: "
            f"{nbytes} bytes, saved in {save_s:.4f}s, loaded in "
            f"{load_s:.4f}s; {half} more steps from it end at "
            f"{resumed[-1]:.6f} against {steps[-1]:.6f} uninterrupted")
        del m, opt, m2, opt2, ck

        # ---- g. profiling: trace and Timer over one GCN epoch
        m = gcn()
        step = make_train_step(m, adam(m), tiled_d)
        tdir = os.path.join(scratch, "trace")

        def epoch():
            step(x_d, y_d, mask_d)

        def traced_epoch():
            shutil.rmtree(tdir, ignore_errors=True)
            with trace(tdir):
                spun(epoch)
            traced, = os.listdir(tdir)
            with open(os.path.join(tdir, traced)) as f:
                events = json.load(f)["traceEvents"]
            kernels = [ev.get("name", "") for ev in events
                       if isinstance(ev, dict) and ev.get("cat") == "kernel"]
            return (len(events), len(set(kernels))), kernels

        # the trace names K1's and K2's kernels
        (n_events, n_kernels), t_trace = complete_capture(
            epoch, traced_epoch, {"spmm_stream_kernel": spmm_stream,
                                  "bsrwalk::walk_kernel": spmm_bsr},
            whole=False)
        timer = Timer()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with timer.section("epoch", sync=x_d):
            start.record()
            step(x_d, y_d, mask_d)
            end.record()
        event_s = start.elapsed_time(end) / 1e3
        if not timer.sections["epoch"] >= event_s:
            raise AssertionError(f"Timer {timer.sections['epoch']} s < CUDA "
                                 f"events {event_s} s")
        log(f"interop g: trace of one GCN epoch ({n_events} events, "
            f"{n_kernels} kernel names; attempt {t_trace}) names "
            f"spmm_stream_kernel and bsrwalk::walk_kernel; Timer section "
            f"{timer.sections['epoch'] * 1e3:.3f} ms >= CUDA events "
            f"{event_s * 1e3:.3f} ms")
        del m, step

        # ---- i. a new value tensor on every call (PyG's GCNConv with
        # cached=False): the bridge's cache and the device memory stay flat
        clear_cache()
        builds.clear()
        n = g_d.nnz
        crow, col = g_d.rowptr.long(), g_d.col[:n].long()
        xk = torch.randn(g_d.num_cols, 32, device="cuda", generator=gen)
        full = torch_bridge.CACHE_SIZE
        held, t_calls = [], []
        for i in range(full + 2):
            value = g_d.value[:n] * (1.0 + 0.01 * i)
            src = torch.sparse_csr_tensor(crow, col, value, size=g_d.shape)
            t0 = time.perf_counter()
            out = torch_spmm(src, xk)
            torch.cuda.synchronize()
            t_calls.append(time.perf_counter() - t0)
            if not torch.isfinite(out).all():
                raise AssertionError("the bridge gave non-finite values")
            del src, value, out
            gc.collect()
            held.append((len(torch_bridge._graph_cache),
                         len(tiling._AUTO_TILED),
                         torch.cuda.memory_allocated()))
        if len(builds) != full + 2:
            raise AssertionError(f"{len(builds)} plan builds over "
                                 f"{full + 2} adjacencies")
        entries, memos, mem = held[full - 1]
        for e, t, b in held[full:]:
            if (e, t) != (entries, memos) or abs(b - mem) > 2**20:
                raise AssertionError(f"the bridge's cache grew: {held}")
        log(f"interop i: a new value tensor on each of {full + 2} calls "
            f"(density-rep, K=32): the bridge's cache holds {entries} "
            f"graphs, auto_tile's memo {memos}, device memory "
            + ", ".join(f"{b / 2**20:.1f}" for _, _, b in held)
            + f" MiB after each call (flat from call {full}); each call "
            f"builds a graph and its plans: "
            + ", ".join(f"{t:.2f}" for t in t_calls) + " s")
        clear_cache()
    finally:
        tiling.build_tiling, torch_bridge.from_scipy = (build_tiling,
                                                        from_scipy)
        autotune._CACHE_PATH, autotune._memory_cache = saved_tune
        clear_cache()
        shutil.rmtree(scratch, ignore_errors=True)

    # ---- h. findbestk on density-rep at K = 32, 41 (phase 9's caches)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(sys.stdout):
        rows = findbestk.sweep(g_d, arrays_d, (32, 41), iters=TUNE_ITERS,
                               verbose=True)
    sweep_s = time.perf_counter() - t0
    log(f"findbestk density-rep --ks 32,41 ({sweep_s:.1f}s):\n"
        + findbestk.table(rows))
    best = dict(rows)[41]
    fresh = graph_from_arrays(arrays_d, "cuda")

    def no_build(*a, **kw):
        raise AssertionError("auto_tile built a plan the tuner persisted")

    saved = tiling._build_fn, tiling.build_minmax_plan
    tiling._build_fn = tiling.build_minmax_plan = no_build
    try:
        t0 = time.perf_counter()
        loaded = tiling.auto_tile(fresh, k=41)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        tiling._build_fn, tiling.build_minmax_plan = saved
    if autotune.lookup(autotune.signature_of(fresh, 41)) != best:
        raise AssertionError("the tune cache lost the K=41 winner")
    if (best["backend"] == "reference") != (loaded is fresh):
        raise AssertionError(f"auto_tile at K=41 did not take {best}")
    log(f"interop h: auto_tile(K=41) of a fresh density-rep graph took the "
        f"recorded winner ({best['backend']} "
        + " ".join(f"{f}={v}" for f, v in best.items()
                   if f not in ("backend", "seconds", "edges_per_s", "fill"))
        + f") from the plan cache in {load_s:.2f}s")
    del fresh, loaded
    log(f"phase 10 (interop and the training tools): "
        f"{time.perf_counter() - t_phase:.1f}s")


def fullscale_path(drive, cases, gen):
    """Phase 11: the main path on the full reddit-sim, 232,965 nodes and
    114.6M edges (bench.py's reddit at scale 1.0), drawn from R-MAT's
    native stream and built by the native builder: the host seconds of
    each step, ``auto_tile``'s v5 plans of A and Aᵀ (threshold after the
    2 GiB block cap, dense coverage), K2 and K1 against their plain
    versions and the hybrid SpMM at K = 32 against the fp32 reference over
    ranges of rows, timed beside its bound; then GCN(602 → 32 → 41),
    ``FULL_EPOCHS`` epochs through K1 + K2 and the same epochs on the
    reference path, the two loss curves within 2e-2 at every epoch, the
    trained model's loss through the kernels against the reference path
    at 2e-2, train accuracy above 0.7; the peak device memory."""
    from isplib_tpu_torch import GCN, graph_from_arrays, train_node_classifier
    from isplib_tpu_torch.data import NodeDataset, gen_gcnsig_graph
    from isplib_tpu_torch.sparse.tiling import auto_tile
    from isplib_tpu_torch.train.loop import _loss_fn

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arrays = gen_gcnsig_graph(N_REAL, E_REAL, CLASSES, FEATURES, SEED,
                              EDGE_MULTIPLE, native_stream=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = graph_from_arrays(arrays, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiled = auto_tile(g)
    torch.cuda.synchronize()
    tile_s = time.perf_counter() - t0
    if tiled is g:
        raise AssertionError("reddit-full: auto_tile did not tile")
    fwd, bwd = tiled.fwd, tiled.bwd
    log(f"reddit-full: {g.num_rows} nodes, {g.nnz} edges; graph made and "
        f"built on the host in {gen_s:.2f}s, uploaded in {upload_s:.2f}s, "
        f"auto_tile {tile_s:.2f}s (host read-back, v5 plans of A and Aᵀ, "
        f"max/min plans)")
    for label, plan in (("A", fwd), ("Aᵀ", bwd)):
        log(f"reddit-full v5 plan of {label}: dense threshold "
            f"{plan.dense_threshold} after the 2 GiB block cap, "
            f"{plan.dense_edges} dense edges in {plan.nb} blocks "
            f"({100 * plan.dense_edges / g.nnz:.2f}% coverage), "
            f"{plan.sparse_edges} residual edges in {plan.nseg} segments")

    rows, whole = check_and_time("reddit-full", g, tiled, "fwd", 32, gen)
    cases += rows
    for r in rows:
        log(f"{r['kernel']:12s} reddit-full fwd K=32: {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.3f}, library {r['library_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]}), err "
            f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}")
    log(f"hybrid       reddit-full fwd K=32: {whole['hybrid_ms']:.4f} ms, "
        f"bound {whole['bound'][0]:.4f} by {whole['bound'][1]} "
        f"({100 * whole['bound'][0] / whole['hybrid_ms']:.1f}% of it), "
        f"{g.nnz / whole['hybrid_ms'] / 1e6:.3f} Gedges/s; whole-SpMM "
        f"library {whole['library_ms']:.4f} ms; err vs the fp32 reference "
        f"by row ranges {whole['max_abs_err']:.3g} (max |ref| "
        f"{whole['max_abs_ref']:.3g})")

    def dataset(graph):
        return NodeDataset(name="reddit-full", graph=graph, x=arrays["x"],
                           y=arrays["y"], train_mask=arrays["train_mask"],
                           val_mask=arrays["train_mask"],
                           test_mask=arrays["test_mask"],
                           num_classes=CLASSES)

    def gcn():
        return GCN(FEATURES, hidden=32, num_classes=CLASSES, seed=0)

    model = gcn()
    res, _ = drive("GCN full-scale path", ("spmm_bsr", "spmm_stream"),
                   lambda: train_node_classifier(model, dataset(tiled),
                                                 epochs=FULL_EPOCHS))
    ref_model = gcn()
    ref = train_node_classifier(ref_model, dataset(g), epochs=FULL_EPOCHS,
                                tile=False)
    for label, r in (("kernels", res), ("reference path", ref)):
        log(f"reddit-full GCN(602-32-41) through the {label}, "
            f"{FULL_EPOCHS} epochs:\n{r.table()}")
        log(f"reddit-full GCN {label}: epoch {r.train_time_avg * 1e3:.3f} "
            f"ms (std {r.train_time_std * 1e3:.3f}), eval "
            f"{r.test_time * 1e3:.3f} ms; loss {r.losses[0]:.5f} -> "
            f"{r.losses[-1]:.5f}; train acc {r.train_acc:.4f}, test acc "
            f"{r.test_acc:.4f}")
    got, want = np.asarray(res.losses), np.asarray(ref.losses)
    gap = np.abs(got - want) / np.abs(want)
    log(f"reddit-full GCN losses, kernels / reference path, every 5th "
        f"epoch: " + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in
                              zip(got[::5], want[::5]))
        + f"; largest relative gap {gap.max():.3g} (epoch "
        f"{int(gap.argmax())})")
    if not (np.all(np.isfinite(got)) and got[-1] < got[0]):
        raise AssertionError(f"reddit-full GCN: loss not finite or not "
                             f"falling: {res.losses}")
    if not gap.max() <= 2e-2:
        raise AssertionError(f"reddit-full GCN: the loss through the "
                             f"kernels left the reference path's by "
                             f"{gap.max():.3g} > 2e-2")
    if not res.train_acc > 0.7:
        raise AssertionError(f"reddit-full GCN: train accuracy "
                             f"{res.train_acc} <= 0.7 after {FULL_EPOCHS} "
                             f"epochs")
    x = torch.from_numpy(arrays["x"]).cuda()
    y = torch.from_numpy(arrays["y"]).cuda()
    mask = torch.from_numpy(arrays["train_mask"]).cuda()
    model.eval()
    with torch.no_grad():
        l_kernel = float(_loss_fn(model(tiled, x), y, mask, "nll"))
        l_ref = float(_loss_fn(model(g, x, backend="reference"), y, mask,
                               "nll"))
    log(f"reddit-full GCN: trained loss through the kernels "
        f"{l_kernel:.7f}, reference path {l_ref:.7f}")
    if not abs(l_kernel - l_ref) <= 2e-2 * abs(l_ref):
        raise AssertionError(f"reddit-full GCN: trained loss through the "
                             f"kernels {l_kernel} vs reference {l_ref}")
    log(f"reddit-full peak device memory (max_memory_allocated): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del x, y, mask, model, ref_model, tiled, g, arrays
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11 (the main path on the full graph): "
        f"{time.perf_counter() - t_phase:.1f}s")


def bench_stages(stderr: str) -> dict:
    """The ``stages: {...}`` line a bench logs last on stderr."""
    found = [ln for ln in stderr.splitlines() if ln.startswith("stages: ")]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} 'stages:' lines on the bench's "
                             "stderr, not 1")
    return json.loads(found[0][len("stages: "):])


def needs_launches(where: str, launches: dict, names) -> None:
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{where}: {missing} never launched "
                             f"({launches})")


def check_bench(stdout: str, stderr: str) -> dict:
    """``python -m isplib_tpu_torch.bench``'s output: exactly one JSON line
    on stdout with the metric's name, a positive value and a
    ``vs_baseline`` in (0, 1]; the GCN and shard stages logged OK; each
    stage through the kernels of its plans."""
    lines = stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} stdout lines, "
                             f"not 1: {stdout[-2000:]!r}")
    line = json.loads(lines[0])
    if sorted(line) != ["metric", "unit", "value", "vs_baseline"]:
        raise AssertionError(f"the bench's line has the keys {sorted(line)}")
    if line["metric"] != BENCH_METRIC or line["unit"] != "edges/s/chip":
        raise AssertionError(f"the bench's line names {line['metric']!r} in "
                             f"{line['unit']!r}")
    if not (line["value"] > 0 and 0 < line["vs_baseline"] <= 1):
        raise AssertionError(f"the bench's value {line['value']}, "
                             f"vs_baseline {line['vs_baseline']}")
    if not any(ln.startswith("GCN epoch: ") and "[OK]" in ln
               for ln in stderr.splitlines()):
        raise AssertionError("the bench's GCN stage did not log OK")
    if not any(ln.startswith("shard overhead mesh(1): ") and "; OK)" in ln
               for ln in stderr.splitlines()):
        raise AssertionError("the bench's shard stage did not log OK")
    st = bench_stages(stderr)
    for where, launches, names in (
            ("headline", st["headline"]["launches"], ("spmm_bsr",)),
            ("fwd+bwd", st["fwd_bwd"]["launches"], ("spmm_bsr",)),
            ("max", st["max"]["launches"], ("spmm_minmax_v4",)),
            ("density-rep v5", st["densrep"]["v5"]["launches"],
             ("spmm_bsr", "spmm_stream")),
            ("density-rep v2", st["densrep"]["v2"]["launches"],
             ("spmm_v2",)),
            ("shard", st["shard"]["launches_sharded"], ("spmm_bsr",)),
            ("GCN", st["gcn"]["launches"], ("spmm_bsr",))):
        needs_launches(f"bench {where}", launches, names)
    return dict(line=line, stages=st)


def check_bench_fused(stdout: str, stderr: str) -> dict:
    """``python -m isplib_tpu_torch.bench_fused``'s output: two stdout lines
    a pipeline, both errors (against the plain path evaluated in float64)
    within ``BENCH_TOL``, the forward through K5 and the backward through
    K6."""
    st = bench_stages(stderr)
    lines = stdout.splitlines()
    if sorted(st) != ["sigmoid-embed", "tdist-force"] or len(lines) != 4:
        raise AssertionError(f"bench_fused: pipelines {sorted(st)}, "
                             f"{len(lines)} stdout lines")
    for name, r in st.items():
        mine = [ln for ln in lines if ln.startswith(f"{name:14s}:")]
        if (len(mine) != 2 or f"relerr={r['relerr']:.1e}" not in mine[0]
                or f"graderr={r['graderr']:.1e}" not in mine[1]):
            raise AssertionError(f"bench_fused {name}: lines {mine}")
        if not (r["relerr"] <= BENCH_TOL and r["graderr"] <= BENCH_TOL):
            raise AssertionError(f"bench_fused {name}: relerr {r['relerr']}, "
                                 f"graderr {r['graderr']} > {BENCH_TOL}")
        needs_launches(f"bench_fused {name}", r["launches"], ("fused",))
        needs_launches(f"bench_fused {name} fwd+bwd", r["launches_fwd_bwd"],
                       ("fused", "fused_bwd"))
    return st


def run_bench(module: str, args: list[str], env: dict):
    """``python -m module args`` from the checkout's root, its stderr
    logged line by line; fails unless it exits 0."""
    cmd = [sys.executable, "-m", module, *args]
    log(f"phase 12: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=BENCH_TIMEOUT)
    for ln in p.stderr.splitlines():
        log(f"  {module.rsplit('.', 1)[1]} | {ln}")
    for ln in p.stdout.splitlines():
        log(f"  {module.rsplit('.', 1)[1]} stdout | {ln}")
    if p.returncode != 0:
        raise AssertionError(f"{module} exited {p.returncode}")
    log(f"phase 12: {module} ran in {time.perf_counter() - t0:.1f}s")
    return p


def bench_paths(graphs, wholes):
    """Phase 12: the bound of each graph's plan is one bound (phase 3's
    whole-hybrid bound at K = 32 against the bench's
    ``plan_bound_edges_per_s``, 1e-9 relative), then the two measuring
    entry points as a user runs them, each in its own process with a
    fresh graph, plan and tune cache: ``bench --iters 20`` at its default
    scale 0.05 and ``bench_fused --iters 10``."""
    t_phase = time.perf_counter()
    for name, (_, _, tiled) in graphs.items():
        want = wholes[name]["bound"][0]
        got = tiled.nnz / plan_bound_edges_per_s(tiled, BENCH_K) * 1e3
        if not abs(got - want) <= 1e-9 * want:
            raise AssertionError(f"{name}: the bench's plan bound {got} ms "
                                 f"vs phase 3's whole-hybrid {want} ms")
        log(f"phase 12: {name} plan bound at K={BENCH_K} {got:.6f} ms, "
            f"phase 3's whole-hybrid bound {want:.6f} ms")
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix="isplib_tpu_torch_phase12_")
    env = dict(os.environ,
               ISPLIB_TPU_TORCH_CACHE_DIR=os.path.join(scratch, "plans"),
               ISPLIB_TPU_TORCH_TUNE_CACHE=os.path.join(scratch, "tune.json"))
    try:
        p = run_bench("isplib_tpu_torch.bench", ["--iters", "20"], env)
        b = check_bench(p.stdout, p.stderr)
        p = run_bench("isplib_tpu_torch.bench_fused", ["--iters", "10"], env)
        f = check_bench_fused(p.stdout, p.stderr)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    head = b["stages"]["headline"]
    log(f"phase 12: bench line {json.dumps(b['line'])}; headline "
        f"{head['ms']:.4f} ms (median {head['median_ms']:.4f}), GCN epoch "
        f"{b['stages']['gcn']['epoch_ms']:.4f} ms; bench_fused errors "
        + ", ".join(f"{n} {r['relerr']:.1e}/{r['graderr']:.1e} (the fp32 "
                    f"plain path {r['plain_relerr']:.1e}/"
                    f"{r['plain_graderr']:.1e})" for n, r in f.items()))
    log(f"phase 12 (bench and bench_fused): "
        f"{time.perf_counter() - t_phase:.1f}s")


def graph_specs() -> list[tuple[str, int, int, int]]:
    """(name, nodes, edges, seed) of the two GCN-signal graphs, at
    bench.py's sizes: reddit at scale 0.05, and its density-representative
    node count (the full graph's edges per 128x128 block at the same edge
    count), both built as GCN-signal graphs so both can be trained on."""
    n, e = int(N_REAL * SCALE), int(E_REAL * SCALE)
    occ_real = E_REAL / (N_REAL / 128.0) ** 2
    n_dens = int(128 * np.sqrt(e / occ_real))
    return [("reddit-sim", n, e, SEED), ("density-rep", n_dens, e, SEED + 7)]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    # a fresh tune cache and plan cache, so that no earlier entry skips the
    # sweep or a build; set before the port is imported
    caches = tempfile.mkdtemp(prefix="isplib_tpu_torch_smoke_")
    os.environ["ISPLIB_TPU_TORCH_CACHE_DIR"] = os.path.join(caches, "plans")
    os.environ["ISPLIB_TPU_TORCH_TUNE_CACHE"] = os.path.join(caches,
                                                             "tune.json")
    try:
        return smoke()
    finally:
        shutil.rmtree(caches, ignore_errors=True)


def smoke() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import (GCN, GIN, GraphSAGE, graph_from_arrays,
                                  run_model, train_node_classifier)
    from isplib_tpu_torch.data import NodeDataset, gen_gcnsig_graph
    from isplib_tpu_torch.bench import KERNELS, counted
    from isplib_tpu_torch.kernels import build
    from isplib_tpu_torch.sparse.tiling import auto_tile
    from isplib_tpu_torch.train.loop import _loss_fn

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    # the plan builds' log lines (the v1 and v3 schedules' derivation times)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("plan build: %(message)s"))
    logging.getLogger("isplib_tpu_torch").addHandler(handler)
    logging.getLogger("isplib_tpu_torch").setLevel(logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {[p.name for p in libs]} in "
        f"{time.perf_counter() - t0:.1f}s")
    for p in libs:
        for fn, props in ptxas_report(p.with_suffix(".log").read_text()):
            log(f"  ptxas {p.stem.split('-')[0]} {fn}: {props}")

    # ---- graphs ------------------------------------------------------------
    graphs = {}
    for name, nodes, e, seed in graph_specs():
        t0 = time.perf_counter()
        arrays = gen_gcnsig_graph(nodes, e, CLASSES, FEATURES, seed,
                                  EDGE_MULTIPLE)
        gen_s = time.perf_counter() - t0
        g = graph_from_arrays(arrays, "cuda")
        t0 = time.perf_counter()
        tiled = auto_tile(g)
        torch.cuda.synchronize()
        if tiled is g:
            raise AssertionError(f"{name}: auto_tile did not tile")
        graphs[name] = (arrays, g, tiled)
        log(f"{name}: {g.num_rows} nodes, {g.nnz} edges ({gen_s:.1f}s); "
            f"plan {time.perf_counter() - t0:.1f}s: fwd dense "
            f"{tiled.fwd.dense_edges} edges in {tiled.fwd.nb} blocks (thr "
            f"{tiled.fwd.dense_threshold}), residual {tiled.fwd.sparse_edges}"
            f" edges in {tiled.fwd.nseg} segments; bwd dense "
            f"{tiled.bwd.dense_edges}, residual {tiled.bwd.sparse_edges}")

    # ---- sum/mean kernels against their plain versions, and their times --
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    wholes = {}   # the forward hybrid SpMM at K = 32 per graph, for phase 12
    for name, (_, g, tiled) in graphs.items():
        for direction, k in ([("fwd", k) for k in KS + (K_WIDE,)]
                             + [("bwd", k) for k in KS]):
            rows, whole = check_and_time(name, g, tiled, direction, k, gen)
            if (direction, k) == ("fwd", BENCH_K):
                wholes[name] = whole
            cases += rows
            for r in rows:
                log(f"{r['kernel']:12s} {name:11s} {direction} K={k}: "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
                    f"library {r['library_ms']:.4f}, bound "
                    f"{r['bound'][0]:.4f} by {r['bound'][1]}), err "
                    f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}"
                    + (f" from the float64 plain version (the fp32 one "
                       f"{r['plain_err']:.3g})" if "plain_err" in r else ""))
            log(f"hybrid       {name:11s} {direction} K={k}: "
                f"{whole['hybrid_ms']:.4f} ms (bound {whole['bound'][0]:.4f}"
                f" by {whole['bound'][1]}), whole-SpMM library "
                f"{whole['library_ms']:.4f} ms, err vs fp32 reference "
                f"{whole['max_abs_err']:.3g} (max |ref| "
                f"{whole['max_abs_ref']:.3g})")

    # ---- the max/min kernel against its plain version, and its times ------
    for name, (_, g, tiled) in graphs.items():
        for reduce in ("max", "min"):
            for k in MM_KS:
                r = check_and_time_minmax(name, g, tiled, reduce, k, gen)
                cases.append(r)
                log(f"spmm_minmax_v4 {name:11s} {reduce} K={k}: "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library "
                    f"values-only {r['library_ms']:.4f}, bound "
                    f"{r['bound'][0]:.4f} by {r['bound'][1]}); bit-exact; "
                    f"{r['walk']}")

    # ---- the paths ---------------------------------------------------------
    def drive(path, needs, fn):
        """Run ``fn`` with every launch count set to 0 just before it and
        read just after; fail unless each kernel in ``needs`` ran."""
        out, ran = counted(fn)
        launches = {kn: ran.get(kn, 0) for kn in KERNELS}
        log(f"{path} launches: {launches}")
        for kname in needs:
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} never launched on {path}")
        return out, launches

    def dataset(name, graph=None):
        arrays, _, tiled = graphs[name]
        return NodeDataset(name=name, graph=tiled if graph is None else graph,
                           x=arrays["x"],
                           y=arrays["y"], train_mask=arrays["train_mask"],
                           val_mask=arrays["train_mask"],
                           test_mask=arrays["test_mask"],
                           num_classes=CLASSES)

    def train(label, make, names, epochs, graph_of=None):
        runs = []
        for name in names:
            model = make()
            t0 = time.perf_counter()
            res = train_node_classifier(
                model, dataset(name, graph_of and graph_of(name)),
                epochs=epochs)
            wall = time.perf_counter() - t0
            runs.append((name, model, res))
            log(f"{name} {label}, {epochs} epochs:\n{res.table()}")
            log(f"{name} {label} epoch {res.train_time_avg * 1e3:.3f} ms "
                f"(std {res.train_time_std * 1e3:.3f}), eval "
                f"{res.test_time * 1e3:.3f} ms, {wall:.1f}s in all; loss "
                f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, train acc "
                f"{res.train_acc:.4f}, test acc {res.test_acc:.4f}")
        return runs

    def check(label, runs, loss, rtol, min_acc=None, graph_of=None,
              tiled_of=None):
        """Loss finite and falling, accuracy, and the trained model's loss
        through the kernels against the reference path (with ``graph_of``:
        through the kernels on that graph against the unsharded TiledGraph's
        kernels; with ``tiled_of``: on that TiledGraph against the reference
        path)."""
        for name, model, res in runs:
            if not np.all(np.isfinite(res.losses)):
                raise AssertionError(f"{name} {label}: non-finite loss "
                                     f"{res.losses}")
            if not res.losses[-1] < res.losses[0]:
                raise AssertionError(f"{name} {label}: loss did not fall: "
                                     f"{res.losses}")
            if min_acc is not None and not res.train_acc > min_acc:
                raise AssertionError(f"{name} {label}: train accuracy "
                                     f"{res.train_acc} <= {min_acc}")
            arrays, g, tiled = graphs[name]
            x = torch.from_numpy(arrays["x"]).cuda()
            y = torch.from_numpy(arrays["y"]).cuda()
            mask = torch.from_numpy(arrays["train_mask"]).cuda()
            ran, ref = (tiled, g) if graph_of is None else (graph_of(name),
                                                             tiled)
            if tiled_of is not None:
                ran = tiled_of(name)
            model.eval()
            # a plain CSRGraph is the reference only under that backend:
            # "auto" would tile it
            with torch.no_grad():
                l_kernel = float(_loss_fn(model(ran, x), y, mask, loss))
                l_ref = float(_loss_fn(
                    model(ref, x, backend=("reference" if graph_of is None
                                           else None)), y, mask, loss))
            log(f"{name} {label}: trained loss through the kernels "
                f"{l_kernel:.7f}, "
                + (f"reference path {l_ref:.7f}" if graph_of is None else
                   f"unsharded TiledGraph {l_ref:.7f}"))
            if not abs(l_kernel - l_ref) <= rtol * abs(l_ref):
                raise AssertionError(f"{name} {label}: loss through the "
                                     f"kernels {l_kernel} vs reference "
                                     f"{l_ref} (rtol {rtol})")

    both = list(graphs)
    gcn_runs, gcn_launches = drive(
        "GCN path", ("spmm_bsr", "spmm_stream"),
        lambda: train("GCN(602-32-41)", lambda: GCN(
            FEATURES, hidden=32, num_classes=CLASSES, seed=0), both, EPOCHS))
    check("GCN", gcn_runs, "nll", 2e-2, min_acc=0.7)

    sage_runs, sage_launches = drive(
        "GraphSAGE-max path", ("spmm_minmax_v4",),
        lambda: train("GraphSAGE-max(602-32-41)", lambda: GraphSAGE(
            FEATURES, hidden=32, num_classes=CLASSES, aggr="max", seed=0),
            both, EPOCHS))
    check("GraphSAGE-max", sage_runs, "nll", 1e-4, min_acc=0.7)

    for label, needs, make, loss, rtol in (
            ("GraphSAGE-min", ("spmm_minmax_v4",), lambda: GraphSAGE(
                FEATURES, 32, CLASSES, aggr="min", seed=0), "nll", 1e-4),
            ("GraphSAGE-mean", ("spmm_bsr",), lambda: GraphSAGE(
                FEATURES, 32, CLASSES, aggr="mean", seed=0), "nll", 2e-2),
            ("GIN", ("spmm_bsr",), lambda: GIN(
                FEATURES, 32, CLASSES, seed=0), "ce", 2e-2)):
        runs, _ = drive(f"{label} path", needs, lambda make=make, label=label:
                        train(label, make, ["reddit-sim"], SHORT_EPOCHS))
        check(label, runs, loss, rtol)

    cli = ["sage", "reddit-sim", "--aggr", "max", "--scale", str(SCALE),
           "--epochs", "2"]
    log(f"CLI: python -m isplib_tpu_torch.run_model {' '.join(cli)}")
    drive("CLI path", ("spmm_minmax_v4",), lambda: run_model.main(cli))

    # ---- where an epoch's time goes ----------------------------------------
    # (the profiler slows the host, so the idle share is taken against the
    # unprofiled epoch time of the training run)
    for label, runs in (("GCN", gcn_runs), ("GraphSAGE-max", sage_runs)):
        for name, model, res in runs:
            arrays, _, tiled = graphs[name]
            prof_ms, busy_ms, per_kernel = profile_epochs(model, tiled,
                                                          arrays)
            idle = 1.0 - busy_ms / (res.train_time_avg * 1e3)
            top = list(per_kernel.items())[:8]
            log(f"{name} {label} profile: device busy {busy_ms:.3f} ms per "
                f"epoch, idle {100 * idle:.1f}% of the "
                f"{res.train_time_avg * 1e3:.3f} ms epoch (profiled epoch "
                f"{prof_ms:.3f} ms); spmm_stream_kernel "
                f"{kernel_share(per_kernel, 'spmm_stream_kernel', busy_ms)}; "
                + "; ".join(f"{k[:48]} {v:.3f}" for k, v in top))

    # ---- SDDMM and FusedMM (K4, K5, K6) ------------------------------------
    fused_launches, sddmm_launches = fused_paths(graphs, cases, drive, gen)

    # ---- the row-sharded path (K1/K2 per shard, K8, K7) -------------------
    unsharded = {(label, name): res for label, runs in (
        ("GCN", gcn_runs), ("GraphSAGE-max", sage_runs))
        for name, _, res in runs}
    v5_launches, v2_launches, mm_launches = sharded_paths(
        graphs, cases, drive, train, check, unsharded, gen)

    # ---- the tuner and plan generations 1-3 (K9, K10) ----------------------
    version_launches = tuner_paths(graphs, cases, drive, train, check, gen)

    # ---- interop and the training tools (K1/K2 through the bridge, K3) ----
    interop_paths(graphs, drive, dataset, gen)

    # ---- the main path on the full 114.6M-edge graph (K1, K2) -------------
    fullscale_path(drive, cases, gen)

    # ---- the measuring entry points: bench and bench_fused ---------------
    bench_paths(graphs, wholes)

    # ---- the kernel table, each kernel at K = 32 forward on the graph whose
    # edges it carries: the dense blocks of reddit-sim, the residual edges
    # of the density-representative graph, all edges for max/min (on the
    # density-representative graph, whose x rows are gathered from HBM at
    # K = 602); launches from the path that runs the kernel
    src = {"spmm_bsr": ("isplib_tpu_torch/kernels/csrc/spmm_bsr.cu",
                        "isplib_tpu/kernels/spmm_bsr2.py:42", "reddit-sim",
                        gcn_launches),
           "spmm_stream": ("isplib_tpu_torch/kernels/csrc/spmm_stream.cu",
                           "isplib_tpu/kernels/spmm_pallas_v4.py:46",
                           "density-rep", gcn_launches),
           "spmm_minmax_v4": (
               "isplib_tpu_torch/kernels/csrc/spmm_minmax_v4.cu",
               "isplib_tpu/kernels/spmm_minmax_v4.py:50", "density-rep",
               sage_launches),
           # K4 on the SDDMM path's graph; K5, K6 on the sigmoid embedding
           # kernel (both passes of K6 in one time)
           "sddmm": ("isplib_tpu_torch/kernels/csrc/sddmm.cu",
                     "isplib_tpu/kernels/sddmm_pallas.py:47", "density-rep",
                     sddmm_launches),
           "fused": ("isplib_tpu_torch/kernels/csrc/fused.cu",
                     "isplib_tpu/kernels/fused_pallas.py:49", "rmat",
                     fused_launches),
           "fused_bwd": ("isplib_tpu_torch/kernels/csrc/fused_bwd.cu",
                         "isplib_tpu/kernels/fused_pallas_bwd.py:61", "rmat",
                         fused_launches),
           # K8 and K7 on shard 0's local plans of reddit-sim; launches from
           # the sharded GCN (version 2) and GraphSAGE-max paths
           "spmm_v2": ("isplib_tpu_torch/kernels/csrc/spmm_v2.cu",
                       "isplib_tpu/kernels/spmm_pallas_v2.py:82",
                       "reddit-sim", v2_launches),
           "spmm_minmax": ("isplib_tpu_torch/kernels/csrc/spmm_minmax.cu",
                           "isplib_tpu/kernels/spmm_minmax.py:77",
                           "reddit-sim", mm_launches),
           # K9 on density-rep's v3 plan (threshold 64, g = 32), K10 on its
           # v1 plan; launches from GCN through versions 3 and 1
           "spmm_bsr_v3": ("isplib_tpu_torch/kernels/csrc/spmm_bsr_v3.cu",
                           "isplib_tpu/kernels/spmm_bsr.py:40",
                           "density-rep", version_launches[3]),
           "spmm_rowblock": (
               "isplib_tpu_torch/kernels/csrc/spmm_rowblock.cu",
               "isplib_tpu/kernels/spmm_pallas.py:95", "density-rep",
               version_launches[1])}
    table = []
    for kname, (source, replaces, gname, launches) in src.items():
        row = next(r for r in cases if r["kernel"] == kname
                   and r["graph"] == gname and r.get("direction", "fwd")
                   == "fwd" and r.get("reduce", "max") == "max"
                   and r.get("case", "dot") in ("dot", "sigmoid-embed",
                                                "shard 0 loc")
                   and r["k"] == 32)
        table.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in cases
                               if r["kernel"] == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"]})

    log(f"every check passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
