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
   1e-4·max|plain|) and the hybrid SpMM against the fp32 reference (bf16
   contract: rtol = atol/max = 2e-2); times the kernel, its plain version
   and the one PyTorch call that computes the same product
   (``torch.sparse.mm`` on a CSR tensor, the yardstick ``library_ms``) with
   CUDA events, beside the bound max(bytes / 3.35 TB/s, operations / peak)
   of that call's inputs.
4. Max/min kernel (K3), on both graphs, max and min, at K = 32, 41 and 602:
   out bit for bit and arg exactly equal to the plain version (exact fp32),
   and equal as numbers to the reference path; times the kernel, its plain
   version and ``scatter_reduce_(..., "amax"|"amin", include_self=False)``
   over precomputed (E, K) messages (values only, no winning ids: no
   PyTorch call returns them), beside the bound.
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

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line; every
number it measures is logged on the lines before.  Any failed check raises:
the exit code is then non-zero and the last line is not printed.  Without a
CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import warnings
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12    # dense bf16 tensor-core peak
FP32_FLOPS = 67e12            # fp32 outside the tensor cores

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


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


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


def check_and_time(name, graph, tiled, direction, k, gen):
    """One (graph, direction, K) case: both kernels against their plain
    versions, the hybrid against the fp32 reference, and the timings."""
    from isplib_tpu_torch.kernels import spmm_bsr, spmm_stream
    from isplib_tpu_torch.kernels.spmm_hybrid import spmm_hybrid
    from isplib_tpu_torch.ops import reference

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

    # ---- K1: residual edges, from a zero output ---------------------------
    got1 = torch.zeros(plan.num_rows, k, device=x.device)
    want1 = torch.zeros_like(got1)
    spmm_stream.spmm_stream(plan, x, got1)
    spmm_stream.spmm_stream_plain(plan, x, want1)
    torch.cuda.synchronize()
    err1 = float((got1 - want1).abs().max())
    tol1 = 1e-4 * float(want1.abs().max())
    if not err1 <= tol1:
        raise AssertionError(f"spmm_stream {name}/{direction}/K={k}: max err "
                             f"{err1} > {tol1}")
    lib_r = csr(plan.res_rowptr, plan.res_col, plan.res_val, g.shape)
    used_cols = int(torch.unique(plan.res_col).numel())
    used_rows = int((plan.res_rowptr.diff() > 0).sum())
    rows.append(dict(
        kernel="spmm_stream", graph=name, direction=direction, k=k,
        max_abs_err=err1, tol=tol1,
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
    ref = reference.spmm_raw(g.row, g.col, g.value, g.deg, x, g.num_rows,
                             "sum")
    scale = float(ref.abs().max())
    herr = float((hyb - ref).abs().max())
    if not bool(torch.isfinite(hyb).all()) or not torch.allclose(
            hyb, ref, rtol=2e-2, atol=2e-2 * scale):
        raise AssertionError(f"hybrid {name}/{direction}/K={k} vs reference: "
                             f"max err {herr} (max |ref| {scale})")
    lib_all = csr(g.rowptr, g.col[:g.nnz], g.value[:g.nnz], g.shape)
    whole = dict(max_abs_err=herr, max_abs_ref=scale,
                 hybrid_ms=cuda_ms(lambda: spmm_hybrid(plan, x)),
                 library_ms=cuda_ms(lambda: torch.sparse.mm(lib_all, x)))
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
        max_abs_err=err, nsplit=plan.nsplit, nseg=plan.nseg,
        ms=cuda_ms(kernel, iters=10 if wide else 30),
        plain_ms=cuda_ms(plain, iters=2 if wide else 5, warmup=1),
        library_ms=lib_ms,
        bound=bound_ms(
            (graph.num_rows + 1) * 4 + n * 8 + (2 * plan.nseg + 1) * 4
            + used_cols * k * 4 + graph.num_rows * k * 8,
            2.0 * n * k, FP32_FLOPS))


def profile_epochs(model, graph, arrays, epochs: int = 5):
    """Where an epoch's time goes: ``torch.profiler`` over ``epochs`` more
    training epochs (after one untimed), returning the profiled epoch time
    on CUDA events, the device's busy time per epoch (kernels, copies and
    sets; annotation ranges excluded) and the busy time per kernel name."""
    from torch.profiler import ProfilerActivity, profile

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import (GCN, GIN, GraphSAGE, graph_from_arrays,
                                  run_model, train_node_classifier)
    from isplib_tpu_torch.data import NodeDataset, gen_gcnsig_graph
    from isplib_tpu_torch.kernels import (build, spmm_bsr, spmm_minmax_v4,
                                          spmm_stream)
    from isplib_tpu_torch.sparse.tiling import auto_tile
    from isplib_tpu_torch.train.loop import _loss_fn

    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
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
    # bench.py's sizes: reddit at scale 0.05, and its density-representative
    # node count (the full graph's edges per 128x128 block at the same edge
    # count), both built as GCN-signal graphs so both can be trained on
    n, e = int(N_REAL * SCALE), int(E_REAL * SCALE)
    occ_real = E_REAL / (N_REAL / 128.0) ** 2
    n_dens = int(128 * np.sqrt(e / occ_real))
    graphs = {}
    for name, nodes, seed in (("reddit-sim", n, SEED),
                              ("density-rep", n_dens, SEED + 7)):
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
    for name, (_, g, tiled) in graphs.items():
        for direction, k in ([("fwd", k) for k in KS + (K_WIDE,)]
                             + [("bwd", k) for k in KS]):
            rows, whole = check_and_time(name, g, tiled, direction, k, gen)
            cases += rows
            for r in rows:
                log(f"{r['kernel']:12s} {name:11s} {direction} K={k}: "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
                    f"library {r['library_ms']:.4f}, bound "
                    f"{r['bound'][0]:.4f} by {r['bound'][1]}), err "
                    f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}")
            log(f"hybrid       {name:11s} {direction} K={k}: "
                f"{whole['hybrid_ms']:.4f} ms, whole-SpMM library "
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
                    f"{r['bound'][0]:.4f} by {r['bound'][1]}); bit-exact, "
                    f"{r['nsplit']} split rows of {r['nseg']} segments")

    # ---- the paths ---------------------------------------------------------
    kernels = {"spmm_bsr": spmm_bsr, "spmm_stream": spmm_stream,
               "spmm_minmax_v4": spmm_minmax_v4}

    def drive(path, needs, fn):
        """Run ``fn`` with every launch count set to 0 just before it and
        read just after; fail unless each kernel in ``needs`` ran."""
        for mod in kernels.values():
            mod.LAUNCHES = 0
        out = fn()
        launches = {kn: mod.LAUNCHES for kn, mod in kernels.items()}
        log(f"{path} launches: {launches}")
        for kname in needs:
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} never launched on {path}")
        return out, launches

    def dataset(name):
        arrays, _, tiled = graphs[name]
        return NodeDataset(name=name, graph=tiled, x=arrays["x"],
                           y=arrays["y"], train_mask=arrays["train_mask"],
                           val_mask=arrays["train_mask"],
                           test_mask=arrays["test_mask"],
                           num_classes=CLASSES)

    def train(label, make, names, epochs):
        runs = []
        for name in names:
            model = make()
            t0 = time.perf_counter()
            res = train_node_classifier(model, dataset(name), epochs=epochs)
            wall = time.perf_counter() - t0
            runs.append((name, model, res))
            log(f"{name} {label}, {epochs} epochs:\n{res.table()}")
            log(f"{name} {label} epoch {res.train_time_avg * 1e3:.3f} ms "
                f"(std {res.train_time_std * 1e3:.3f}), eval "
                f"{res.test_time * 1e3:.3f} ms, {wall:.1f}s in all; loss "
                f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, train acc "
                f"{res.train_acc:.4f}, test acc {res.test_acc:.4f}")
        return runs

    def check(label, runs, loss, rtol, min_acc=None):
        """Loss finite and falling, accuracy, and the trained model's loss
        through the kernels against the reference path."""
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
            model.eval()
            with torch.no_grad():
                l_kernel = float(_loss_fn(model(tiled, x), y, mask, loss))
                l_ref = float(_loss_fn(model(g, x), y, mask, loss))
            log(f"{name} {label}: trained loss through the kernels "
                f"{l_kernel:.7f}, reference path {l_ref:.7f}")
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
                f"{prof_ms:.3f} ms); "
                + "; ".join(f"{k[:48]} {v:.3f}" for k, v in top))

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
               sage_launches)}
    table = []
    for kname, (source, replaces, gname, launches) in src.items():
        row = next(r for r in cases if r["kernel"] == kname
                   and r["graph"] == gname and r.get("direction", "fwd")
                   == "fwd" and r.get("reduce", "max") == "max"
                   and r["k"] == 32)
        table.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in cases
                               if r["kernel"] == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"]})

    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
