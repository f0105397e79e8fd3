#!/usr/bin/env python3
"""Attribute the time of the dense-block walk on one CUDA card: where do K9
(``isplib_tpu_torch/kernels/csrc/spmm_bsr_v3.cu``, the v3 celled BSR) and
K2 (``spmm_bsr.cu``, the v5 hybrid's dense half), which share the walk of
``bsr_walk.cuh``, spend it?

    python3 probe_bsr_v3.py

Builds copies of both kernels with the walk's parts cut out (the
tensor-core products, all compute, the block copies, the x-tile copies)
and with other shapes (K tiles of 256 above K = 256, three at K = 602
where the walk takes two of 320; the K tile as the fast grid index), each
with the port's nvcc flags into ``isplib_tpu_torch/_build/probe/``, and
times every variant with CUDA events at K = 32, 41 and 602: K9 on
``chip_smoke.py``'s density-representative graph (its v3 plan at
threshold 64, g = 32), also with its schedule cut into pieces of up to 16
and 64 members (the plan's own pieces hold up to 32); K2 on both of
``chip_smoke.py``'s graphs (the v5 plans ``auto_tile`` builds: reddit-sim
at threshold 64, density-rep at 128), also with its schedule cut into
pieces of 8 to 64 blocks (the plan's own hold up to ``PIECE_BLOCKS``).
Then K8 (``spmm_v2.cu``, on the row walk of ``row_walk.cuh`` that it
shares with K10), the same way: copies with the walk's x gathers cut out,
with K tiles of 32, 128, 256 or 320 features (K8 takes up to 160), with
the next 32 slots decoded ahead, with 4 or 16 gathers in flight where it
keeps 8, with the largest L1 share of the SM's memory, and with the K
tile as the fast grid index, and the kernel with its rows cut into items of 32 to 256 slots
(the plan's own hold up to ``ITEM_SLOTS``), beside ``torch.sparse.mm`` of
the same edges, on reddit-sim's shard 0 (the version-2 route's local and
halo plans of a 4-way ``partition_rows``), density-rep's full version-2
plan (256/512/512) and its version-3 residual.  A variant that cuts work
out computes garbage: only the whole kernel's error against the plain
version is meaningful; it is printed for every variant.  Exits 2 without
a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "isplib_tpu_torch", "kernels", "csrc")

_MMA = ("            mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);\n"
        "            mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);")
_WIDE = "  return launch_walk<320, 2, 3, 1>("
# edits of bsr_walk.cuh, the walk both kernels share
VARIANTS = {
    "kernel": [],
    "no products": [(_MMA, "            acc[mt][nt][0] += "
                           "__uint_as_float(b[0] ^ a[mt][0]);")],
    "copies only": [("    if (!live) continue;", "    continue;")],
    "no block copies": [("    layout.stage(a_s, mb.x, c0, tid);", "")],
    "no x copies": [(
        "    for (int q = tid; q < DEPTH * KT / 8; q += THREADS) {",
        "    for (int q = tid; q < 0; q += THREADS) {")],
    "K tiles of 256": [(_WIDE, "  return launch_walk<256, 2, 4, 1>(")],
    "K tile fast": [
        ("  const int k0 = blockIdx.y * KT;",
         "  const int k0 = blockIdx.x * KT;"),
        ("  const int4 pc = pieces[blockIdx.x];",
         "  const int4 pc = pieces[blockIdx.y];"),
        ("  const dim3 grid(n_pieces, (k + KT - 1) / KT);",
         "  const dim3 grid((k + KT - 1) / KT, n_pieces);")],
}
_SWITCH = "  switch ((lanes + passes - 1) / passes) {"


def _row_wide(nk):
    """Edits of the row walk: K tiles of 32*nk features above K = 128."""
    return [(_SWITCH, f"  switch (lanes <= 4 ? lanes : {nk}) {{"),
            ("  }\n  if constexpr (MAX_NK == 5)",
             f"    case {nk}:\n      return launch_walk<{nk}, ADD>(slots, "
             "order, row_ptr, seg_ptr, seg_row, x, out, nseg, k, stream);\n"
             "  }\n  if constexpr (MAX_NK == 5)")]


# edits of row_walk.cuh (the walk K8 shares with K10) and of spmm_v2.cu
ROW_VARIANTS = {
    "kernel": [],
    "no gathers": [("if (f < k) acc[t] = fmaf(vj, __ldg(xr + f), acc[t]);",
                    "if (f < k) acc[t] = fmaf(vj, __int_as_float(cj), "
                    "acc[t]);")],
    "K tiles of 32": [(_SWITCH, "  switch (1) {")],
    "K tiles of 128": [("run<true, 5>", "run<true, 4>"),
                       ("run<false, 5>", "run<false, 4>")],
    "K tiles of 256": _row_wide(8),
    "K tiles of 320": _row_wide(10),
    "decode ahead": [(
        "  for (int b = e0; b < e1; b += 32) {\n"
        "    int c = 0;\n"
        "    float v = 0.f;\n"
        "    if (b + lane < e1) slots.decode(order[b + lane], c, v);"
        "  // this lane's\n",
        "  int cn = 0;\n"
        "  float vn = 0.f;\n"
        "  if (e0 + lane < e1) slots.decode(order[e0 + lane], cn, vn);\n"
        "  for (int b = e0; b < e1; b += 32) {\n"
        "    const int c = cn;\n"
        "    const float v = vn;\n"
        "    if (b + 32 + lane < e1) slots.decode(order[b + 32 + lane], cn,"
        " vn);\n")],
    "gathers 4 deep": [("#pragma unroll 8\n", "#pragma unroll 4\n")],
    "gathers 16 deep": [("#pragma unroll 8\n", "#pragma unroll 16\n")],
    "max L1 carveout": [(
        "  const int per_block = THREADS / 32;\n",
        "  const int per_block = THREADS / 32;\n"
        "  cudaFuncSetAttribute(walk_kernel<NK, ADD, S>,\n"
        "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
        " 0);\n")],
    "K tile fast": [
        ("  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;",
         "  const int item = (blockIdx.y * THREADS + threadIdx.x) >> 5;"),
        ("  const int f0 = blockIdx.y * 32 * NK + lane;",
         "  const int f0 = blockIdx.x * 32 * NK + lane;"),
        ("  const dim3 grid((nseg + per_block - 1) / per_block,\n"
         "                  (k + 32 * NK - 1) / (32 * NK));",
         "  const dim3 grid((k + 32 * NK - 1) / (32 * NK),\n"
         "                  (nseg + per_block - 1) / per_block);")],
}
# kernel: (source, entry, pointer arguments, int arguments)
KERNELS = {"K9": ("spmm_bsr_v3.cu", "spmm_bsr_v3_launch", 7, 8),
           "K2": ("spmm_bsr.cu", "spmm_bsr_launch", 7, 7)}


def build_variants(out_dir: str) -> dict:
    """(kernel, variant) -> the ctypes launch function, all built at once
    (one nvcc each), each variant in a directory of its own with its
    edited copy of the walk."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    def read(name):
        with open(os.path.join(CSRC, name)) as f:
            return f.read()

    walk = read("bsr_walk.cuh")
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = walk
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the walk no longer has {old!r}")
            text = text.replace(old, new)
        d = os.path.join(out_dir, f"v{i}")
        os.makedirs(d, exist_ok=True)
        files = {"bsr_walk.cuh": text, "bf16_mma.cuh": read("bf16_mma.cuh")}
        files.update({src: read(src) for src, *_ in KERNELS.values()})
        for fname, body in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(body)
        for kname, (src, *_) in KERNELS.items():
            lib = os.path.join(d, f"{kname}.so")
            procs[(kname, name)] = (lib, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", lib, os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kname, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kname} {name}:\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln]
        print(f"built {kname} {name}: {regs}", flush=True)
        _, entry, n_ptr, n_int = KERNELS[kname]
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[(kname, name)] = fn
    return fns


def build_row_variants(out_dir: str) -> dict:
    """variant -> the ctypes launch function of K8 built on an edited copy
    of the row walk, all built at once."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path
    with open(os.path.join(CSRC, "row_walk.cuh")) as f:
        walk = f.read()
    with open(os.path.join(CSRC, "spmm_v2.cu")) as f:
        source = f.read()
    procs = {}
    for i, (name, edits) in enumerate(ROW_VARIANTS.items()):
        text, src = walk, source
        for old, new in edits:
            if old in text:
                text = text.replace(old, new)
            elif old in src:
                src = src.replace(old, new)
            else:
                raise RuntimeError(f"{name}: K8 no longer has {old!r}")
        d = os.path.join(out_dir, f"r{i}")
        os.makedirs(d, exist_ok=True)
        for fname, body in (("row_walk.cuh", text), ("spmm_v2.cu", src)):
            with open(os.path.join(d, fname), "w") as f:
                f.write(body)
        lib = os.path.join(d, "K8.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", lib,
             os.path.join(d, "spmm_v2.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for K8 {name}:\n{log}")
        fn = ctypes.CDLL(lib).spmm_v2_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        print(f"built K8 {name}", flush=True)
    return fns


def launch_k8(fn, plan, x):
    """One call of a K8 variant, as the wrapper ``spmm_v2`` makes it (a
    fresh output)."""
    k, s = x.shape[1], plan.sched
    out = torch.empty(plan.num_rows, k, device=x.device)
    err = fn(plan.edges.data_ptr(), s.chunk_col.data_ptr(),
             s.order.data_ptr(), s.row_ptr.data_ptr(), s.seg_ptr.data_ptr(),
             s.seg_row.data_ptr(), s.zero_rows.data_ptr(), x.data_ptr(),
             out.data_ptr(), s.nseg, s.zero_rows.shape[0], plan.eb, k, 0,
             x.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def launch_k9(fn, plan, x):
    """One call of a K9 variant, as the wrapper ``spmm_bsr_v3`` makes it."""
    k, s = x.shape[1], plan.sched
    out = torch.empty(plan.num_rows, k, device=x.device)
    xb = torch.empty(plan.c_padded, -(-k // 8) * 8, dtype=torch.bfloat16,
                     device=x.device)
    err = fn(plan.blocks.data_ptr(), s.members.data_ptr(),
             s.pieces.data_ptr(), s.zero_rbs.data_ptr(), x.data_ptr(),
             xb.data_ptr(), out.data_ptr(), s.n_pieces, s.zero_rbs.shape[0],
             plan.g, plan.num_rows, plan.num_cols, plan.c_padded, k,
             x.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def launch_k2(fn, plan, x):
    """One call of a K2 variant, as the wrapper ``spmm_bsr`` makes it."""
    k, s = x.shape[1], plan.sched
    out = torch.empty(plan.num_rows, k, device=x.device)
    xb = torch.empty(-(-plan.num_cols // 128) * 128, -(-k // 8) * 8,
                     dtype=torch.bfloat16, device=x.device)
    err = fn(plan.blocks.data_ptr(), s.members.data_ptr(),
             s.pieces.data_ptr(), s.zero_rbs.data_ptr(), x.data_ptr(),
             xb.data_ptr(), out.data_ptr(), s.n_pieces, s.zero_rbs.shape[0],
             plan.num_rows, plan.num_cols, xb.shape[0], k, x.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def time_cases(label, cases, launch, k, x, want):
    """Time each (name, fn, plan) case at K with CUDA events; print its
    ms, pieces (or work items) and error against the plain version."""
    scale = float(want.abs().max())
    for name, fn, p in cases:
        ms = cs.cuda_ms(lambda: launch(fn, p, x), iters=20)
        err = float((launch(fn, p, x) - want).abs().max()) / scale
        s = p.sched
        shape = (f"{s.n_pieces} pieces, {int(s.pieces[:, 3].sum())} split"
                 if hasattr(s, "pieces") else f"{s.nseg} items")
        print(f"{label} K={k} {name:24s} {ms:.4f} ms ({shape}), "
              f"err/max|plain| {err:.2e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bsr_v3: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import graph_from_arrays
    from isplib_tpu_torch.data import gen_gcnsig_graph
    from isplib_tpu_torch.kernels.spmm_bsr import spmm_bsr_plain
    from isplib_tpu_torch.kernels.spmm_bsr_v3 import spmm_bsr_v3_plain
    from isplib_tpu_torch.sparse.tiling import host_arrays
    from isplib_tpu_torch.sparse.tiling_v3 import (build_plan_v3_arrays,
                                                   derive_bsr_schedule)
    from isplib_tpu_torch.sparse.tiling_v5 import (PIECE_BLOCKS,
                                                   build_hybrid_plan,
                                                   derive_block_schedule)

    print(cs.card_line(), flush=True)
    out_dir = os.path.join(ROOT, "isplib_tpu_torch", "_build", "probe")
    fns = build_variants(out_dir)
    row_fns = build_row_variants(out_dir)
    # chip_smoke.py's two graphs
    e = int(cs.E_REAL * cs.SCALE)
    occ = cs.E_REAL / (cs.N_REAL / 128.0) ** 2
    graphs = {}
    for name, nodes, seed, thr in (
            ("density-rep", int(128 * np.sqrt(e / occ)), cs.SEED + 7, 128),
            ("reddit-sim", int(cs.N_REAL * cs.SCALE), cs.SEED, 64)):
        arrays = gen_gcnsig_graph(nodes, e, cs.CLASSES, cs.FEATURES, seed,
                                  cs.EDGE_MULTIPLE)
        g = graph_from_arrays(arrays, "cuda")
        a, n = host_arrays(g), g.nnz
        graphs[name] = (g, (a["row"][:n], a["col"][:n], a["value"][:n],
                            g.num_rows, g.num_cols), thr)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # ---- K9 on density-rep's v3 plan --------------------------------------
    g, coo, _ = graphs["density-rep"]
    plan = build_plan_v3_arrays(*coo, rb=256, ct=128, eb=512,
                                dense_threshold=64, g=32, k=32,
                                device="cuda").bsr
    print(f"density-rep v3: {plan.sched.n_real} real members in "
          f"{plan.sched.n_pieces} pieces", flush=True)
    for k in (32, 41, 602):
        x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
        cases = [(name, fns[("K9", name)], plan) for name in VARIANTS]
        cases += [(f"kernel, pieces <= {pm}", fns[("K9", "kernel")],
                   dataclasses.replace(plan, sched=derive_bsr_schedule(
                       plan, piece_members=pm))) for pm in (16, 64)]
        time_cases("K9 density-rep", cases, launch_k9, k, x,
                   spmm_bsr_v3_plain(plan, x))
    del plan

    # ---- K2 on both graphs' v5 plans --------------------------------------
    for gname, (g, coo, thr) in graphs.items():
        plan = build_hybrid_plan(*coo, "cuda", dense_threshold=thr)
        print(f"{gname} v5 (threshold {thr}): {plan.nb} blocks over "
              f"{plan.n_br} block-rows, at most "
              f"{int(plan.blk_rowptr.diff().max())} in one; "
              f"{plan.sched.n_pieces} pieces of <= {PIECE_BLOCKS}",
              flush=True)
        for k in (32, 41, 602):
            x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
            cases = [(name, fns[("K2", name)], plan) for name in VARIANTS]
            cases += [(f"kernel, pieces <= {pb}", fns[("K2", "kernel")],
                       dataclasses.replace(plan, sched=derive_block_schedule(
                           plan, piece_blocks=pb)))
                      for pb in (8, 12, 16, 24, 32, 48, 64)
                      if pb != PIECE_BLOCKS]
            time_cases(f"K2 {gname}", cases, launch_k2, k, x,
                       spmm_bsr_plain(plan, x))
        del plan

    # ---- K8 on shard 0's plans and density-rep's full plans ---------------
    from isplib_tpu_torch.dist import partition_rows
    from isplib_tpu_torch.kernels.spmm_v2 import spmm_v2_plain
    from isplib_tpu_torch.sparse.tiling_v2 import (ITEM_SLOTS,
                                                   build_plan_v2_arrays,
                                                   derive_v2_schedule)
    _, coo, _ = graphs["reddit-sim"]
    sg = partition_rows(*coo[:3], coo[3], 4, device="cuda",
                        tiling={"version": 2, "minmax": False}, hold=[0])
    loc, _, halo, _ = sg.shard(0).plans
    _, coo, _ = graphs["density-rep"]
    plans = {"reddit-sim shard 0 loc": loc, "reddit-sim shard 0 halo": halo,
             "density-rep v2": build_plan_v2_arrays(*coo, device="cuda"),
             "density-rep v3 residual": build_plan_v3_arrays(
                 *coo, rb=256, ct=128, eb=512, dense_threshold=64, g=32,
                 k=32, device="cuda").residual}
    del sg
    for pname, plan in plans.items():
        e = plan.edges[:plan.nc].reshape(plan.nc, 3, plan.eb)
        keep = e[:, 1].reshape(-1) != 0
        sl = plan.slots()
        lib = torch.sparse_coo_tensor(
            torch.stack([sl["row"][keep], sl["col"][keep]]), sl["val"][keep],
            (plan.num_rows, plan.num_cols)).coalesce().to_sparse_csr()
        del e, keep, sl
        for k in (32, 41, 602):
            x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
            print(f"K8 {pname} K={k} torch.sparse.mm "
                  f"{cs.cuda_ms(lambda: torch.sparse.mm(lib, x)):.4f} ms",
                  flush=True)
            cases = [(name, fn, plan) for name, fn in row_fns.items()]
            cases += [(f"kernel, items <= {ss}", row_fns["kernel"],
                       dataclasses.replace(plan, sched=derive_v2_schedule(
                           plan, seg_slots=ss)))
                      for ss in (32, 128, 256) if ss != ITEM_SLOTS]
            time_cases(f"K8 {pname}", cases, launch_k8, k, x,
                       spmm_v2_plain(plan, x))
        del lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
