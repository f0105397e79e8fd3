#!/usr/bin/env python3
"""Attribute K9's time on one CUDA card: where does the v3 dense-block
SpMM (``isplib_tpu_torch/kernels/csrc/spmm_bsr_v3.cu``) spend it?

    python3 probe_bsr_v3.py

Builds copies of the kernel's source with parts of its work cut out (the
tensor-core products, all compute, the block copies, the x-tile copies)
and with other shapes (K tiles of 256 above K = 256, three at K = 602
where the kernel takes two of 320; the K tile as the fast grid index),
each with the port's nvcc flags into ``isplib_tpu_torch/_build/probe/``,
and times every variant with CUDA events on ``chip_smoke.py``'s
density-representative graph (its v3 plan at threshold 64, g = 32) at
K = 32, 41 and 602, and the kernel itself with its schedule cut into
pieces of up to 16 and 64 members (the plan's own pieces hold up to 32).
A variant that cuts work out computes garbage: only the whole kernel's
error against the plain version is meaningful; it is printed for every
variant.  Exits 2 without a card.
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
_WIDE = "  return launch_walk<320, 2, 64, 3, 1>("
VARIANTS = {
    "kernel": [],
    "no products": [(_MMA, "            acc[mt][nt][0] += "
                           "__uint_as_float(b[0] ^ a[mt][0]);")],
    "copies only": [("    if (!live) continue;", "    continue;")],
    "no block copies": [(
        "    for (int q = tid; q < DEPTH * BS / 8; q += THREADS) {",
        "    for (int q = tid; q < 0; q += THREADS) {")],
    "no x copies": [(
        "    for (int q = tid; q < DEPTH * KT / 8; q += THREADS) {",
        "    for (int q = tid; q < 0; q += THREADS) {")],
    "K tiles of 256": [(_WIDE, "  return launch_walk<256, 2, 64, 4, 1>(")],
    "K tile fast": [
        ("  const int k0 = blockIdx.y * KT;",
         "  const int k0 = blockIdx.x * KT;"),
        ("  const int4 pc = pieces[blockIdx.x];",
         "  const int4 pc = pieces[blockIdx.y];"),
        ("  const dim3 grid(n_pieces, (k + KT - 1) / KT);",
         "  const dim3 grid((k + KT - 1) / KT, n_pieces);")],
}


def build_variants(out_dir: str) -> dict:
    """name -> the ctypes launch function of each variant, all built at
    once (one nvcc each)."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(CSRC, "bf16_mma.cuh")) as f:
        header = f.read()
    with open(os.path.join(out_dir, "bf16_mma.cuh"), "w") as f:
        f.write(header)
    with open(os.path.join(CSRC, "spmm_bsr_v3.cu")) as f:
        source = f.read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln][:1]
        print(f"built {name}: {regs}", flush=True)
        fn = ctypes.CDLL(lib).spmm_bsr_v3_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, plan, x):
    """One call of a variant, as the wrapper ``spmm_bsr_v3`` makes it."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bsr_v3: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import graph_from_arrays
    from isplib_tpu_torch.data import gen_gcnsig_graph
    from isplib_tpu_torch.kernels.spmm_bsr_v3 import spmm_bsr_v3_plain
    from isplib_tpu_torch.sparse.tiling import host_arrays
    from isplib_tpu_torch.sparse.tiling_v3 import (build_plan_v3_arrays,
                                                   derive_bsr_schedule)

    print(cs.card_line(), flush=True)
    fns = build_variants(os.path.join(ROOT, "isplib_tpu_torch", "_build",
                                      "probe"))
    # chip_smoke.py's density-representative graph and its v3 plan
    e = int(cs.E_REAL * cs.SCALE)
    occ = cs.E_REAL / (cs.N_REAL / 128.0) ** 2
    nodes = int(128 * np.sqrt(e / occ))
    arrays = gen_gcnsig_graph(nodes, e, cs.CLASSES, cs.FEATURES, cs.SEED + 7,
                              cs.EDGE_MULTIPLE)
    g = graph_from_arrays(arrays, "cuda")
    a, n = host_arrays(g), g.nnz
    plan = build_plan_v3_arrays(
        a["row"][:n], a["col"][:n], a["value"][:n], g.num_rows, g.num_cols,
        rb=256, ct=128, eb=512, dense_threshold=64, g=32, k=32,
        device="cuda").bsr
    print(f"density-rep v3: {plan.sched.n_real} real members in "
          f"{plan.sched.n_pieces} pieces", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in (32, 41, 602):
        x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
        want = spmm_bsr_v3_plain(plan, x)
        scale = float(want.abs().max())
        cases = [(name, fn, plan) for name, fn in fns.items()]
        cases += [(f"kernel, pieces <= {pm}", fns["kernel"],
                   dataclasses.replace(plan, sched=derive_bsr_schedule(
                       plan, piece_members=pm))) for pm in (16, 64)]
        for name, fn, p in cases:
            ms = cs.cuda_ms(lambda: launch(fn, p, x), iters=20)
            err = float((launch(fn, p, x) - want).abs().max()) / scale
            print(f"K={k} {name:24s} {ms:.4f} ms ({p.sched.n_pieces} "
                  f"pieces, {int(p.sched.pieces[:, 3].sum())} split), "
                  f"err/max|plain| {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
