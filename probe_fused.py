#!/usr/bin/env python3
"""Attribute the time of the FusedMM kernels on one CUDA card: where do K5
(``isplib_tpu_torch/kernels/csrc/fused.cu``) and the two passes of K6
(``fused_bwd.cu``), which share the lane layout and stages of
``fused_ops.cuh``, spend it?

    python3 probe_fused.py

Builds copies of both kernels with parts cut out or changed, each with the
port's nvcc flags into ``isplib_tpu_torch/_build/probe_fused/`` (all at
once, one nvcc a source):

* no gathers: the gathered rows (y in K5 and pass A, x and g in pass B)
  replaced by values made from the column index, no load;
* no ROP shuffles: the group reductions of t (and of a in K6) cut out;
* lanes per edge 2, 8, 16 or 32 at K <= 32, where the kernels take 4 with
  two float4 a lane (four float4 a lane at 2; one float4, float2 or float
  at 8, 16 or 32, the last two through load and store paths for vectors
  of 2 and 1 float patched into ``fused_ops.cuh``);
* gathers in flight: 8 or 32 gathered floats a lane, where the kernels
  keep 16 (at K = 32: 1 or 4 batches of 8 edges, where they keep 2);
* edge words not ahead: each batch's column and value words fetched
  when it starts, where the kernels fetch them a round ahead;
* first fetch branched: the first edge words of a segment fetched only
  when it has edges, where the kernels clamp the index of an empty
  segment's fetch to edge 0;
* exact SOP: ``expf`` and a true division, where the kernels take the
  MUFU approximations;
* run-time codes: every pipeline on the instances that read the ROP and
  SOP at run time, where the compiled set takes 9 combinations;
* scalar cache: pass A also stores (s*w, ŝ) per edge in CSR order, and
  pass B reads them through the graph's ``csc2csr`` in place of its
  reductions and SOP;
* wide lanes 16: four float4 a lane at 128 < K <= 256, where the kernels
  take 32 lanes with two;

and times every variant with CUDA events on ``chip_smoke.py``'s R-MAT
graph (``scripts/bench_fused.py``'s ``gen_rmat_graph(11648, 5730794,
crc32("reddit"), 4096)``) for the sigmoid embedding kernel, the
t-distribution force model and COPY_RHS + MEAN at K = 32 (the kernel
itself also at 41, padded to 44 as the wrappers pad it, and 256; the
run-time codes also at 256, wide lanes at 256 alone), beside
``torch.sparse.mm`` where one call computes the function (COPY_RHS + MEAN:
A with the mean's values times y, and Aᵀ with the CSC values times g) and
the division of g by the degree that ``FusedMM.backward`` makes for MEAN.
A variant that cuts work out computes garbage: only the whole kernel's
error against the plain version is meaningful; it is printed for every
variant.  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import textwrap

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "isplib_tpu_torch", "kernels", "csrc")

_FAKE = ("  __device__ __forceinline__ void zero() {",
         "  __device__ __forceinline__ void fake(int c) {\n"
         "#pragma unroll\n"
         "    for (int t = 0; t < NV; ++t)\n"
         "#pragma unroll\n"
         "      for (int w = 0; w < W; ++w) v[t].f[w] = 1e-30f * (c + w);\n"
         "  }\n\n"
         "  __device__ __forceinline__ void zero() {")
_K32 = "  if (k <= 32) return f(Cfg<4, 4, 2, ROP, SOP>{});"
# the row load and store for vectors of W = 2 or 1 float (the kernels hold
# float4s alone)
_LOAD4 = ("        const float4 a = __ldg(reinterpret_cast<const float4*>("
          "row + f));\n"
          "        v[t].f[0] = a.x, v[t].f[1] = a.y, v[t].f[2] = a.z, "
          "v[t].f[3] = a.w;\n")
_NARROW = [
    ('  static_assert(W == 4, "a lane holds float4s");\n', ""),
    (_LOAD4,
     "        if constexpr (W == 4) {\n"
     + textwrap.indent(_LOAD4, "  ")
     + "        } else if constexpr (W == 2) {\n"
     "          const float2 a = __ldg(reinterpret_cast<const float2*>("
     "row + f));\n"
     "          v[t].f[0] = a.x, v[t].f[1] = a.y;\n"
     "        } else {\n"
     "          v[t].f[0] = __ldg(row + f);\n"
     "        }\n"),
    ("      *reinterpret_cast<float4*>(row + f) = make_float4(\n"
     "          acc.v[t].f[0], acc.v[t].f[1], acc.v[t].f[2], "
     "acc.v[t].f[3]);\n",
     "#pragma unroll\n"
     "      for (int w = 0; w < W; ++w) row[f + w] = acc.v[t].f[w];\n")]
_GF = "constexpr int GATHER_FLOATS = 16;"
_NEXT = ("    if (b + G * D < e1) nxt.fetch(a.col, a.val, use_w, b + G * D, "
         "last, grp);\n")
_SW = ("      float sw = s_one * cur.w[d], shat = 0.f;\n"
       "      if (rop != NOOP) {")
_SHAT = "        shat = pa * cur.w[d] * sop_grad(sop, s);\n      }"
# (old, new) edits of fused_ops.cuh, fused.cu and fused_bwd.cu
VARIANTS = {
    "kernel": [],
    "no gathers": [
        _FAKE,
        ("yv[d].load(a.y + static_cast<size_t>(cur.c[d]) * k, q, k);",
         "yv[d].fake(cur.c[d]);"),
        ("ov[d].load((PASS_B ? a.x : a.y) + oc, q, k);",
         "ov[d].fake(cur.c[d]);"),
        ("if constexpr (PASS_B) gv[d].load(a.g + oc, q, k);",
         "if constexpr (PASS_B) gv[d].fake(cur.c[d] + 1);")],
    "no ROP shuffles": [("for (int o = L / 2; o > 0; o >>= 1)",
                         "for (int o = 0; o > 0; o >>= 1)")],
    "lanes 2": [(_K32, _K32.replace("<4, 4, 2,", "<4, 2, 4,"))],
    "lanes 8": [(_K32, _K32.replace("<4, 4, 2,", "<4, 8, 1,"))],
    "lanes 16": [(_K32, _K32.replace("<4, 4, 2,", "<2, 16, 1,")), *_NARROW],
    "lanes 32": [(_K32, _K32.replace("<4, 4, 2,", "<1, 32, 1,")), *_NARROW],
    "gathers 8": [(_GF, _GF.replace("16", "8"))],
    "gathers 32": [(_GF, _GF.replace("16", "32"))],
    "first fetch branched": [
        ("  nxt.fetch(a.col, a.val, use_w, e0, last, grp);\n",
         "  if (e0 < e1) nxt.fetch(a.col, a.val, use_w, e0, last, grp);\n")],
    "edge words not ahead": [
        ("  nxt.fetch(a.col, a.val, use_w, e0, last, grp);\n", ""),
        (_NEXT, ""),
        ("    const EdgeWords<G, D> cur = nxt;\n",
         "    EdgeWords<G, D> cur;\n"
         "    cur.fetch(a.col, a.val, use_w, b, last, grp);\n")],
    "exact SOP": [("__fdividef(1.f, 1.f + __expf(-t))",
                   "1.f / (1.f + expf(-t))"),
                  ("__fdividef(1.f, 1.f + t)", "1.f / (1.f + t)")],
    "run-time codes": [(
        "  const bool compiled = vop != VMAX && vop != VMIN && k > 16;",
        "  const bool compiled = false;")],
    "wide lanes 16": [("  return f(Cfg<4, 32, 2, ROP, SOP>{});",
                       "  return f(Cfg<4, 16, 4, ROP, SOP>{});")],
    "scalar cache": [
        ("namespace {\n\nusing namespace fused;",
         "__device__ float2* probe_cache;\n__device__ const int* probe_perm;"
         "\n\nextern \"C\" int probe_set(void* cache, const void* perm) {\n"
         "  cudaMemcpyToSymbol(probe_cache, &cache, sizeof(void*));\n"
         "  cudaMemcpyToSymbol(probe_perm, &perm, sizeof(void*));\n"
         "  return static_cast<int>(cudaGetLastError());\n}\n\n"
         "namespace {\n\nusing namespace fused;"),
        (_SW, _SW.replace("      if (rop != NOOP) {",
                          "      const int ed = min(b + d * G + grp, last);"
                          "\n      if (PASS_B && rop != NOOP) {\n"
                          "        const float2 cs = probe_cache[__ldg("
                          "probe_perm + ed)];\n"
                          "        sw = cs.x, shat = cs.y;\n"
                          "      } else if (rop != NOOP) {")),
        (_SHAT, _SHAT.replace("\n      }",
                              "\n        if (!PASS_B && b + d * G + grp < e1 "
                              "&& q == 0)\n"
                              "          probe_cache[ed] = make_float2(sw, "
                              "shat);\n      }"))],
}
# the widths each variant is timed at (the rest at K = 32 only)
WIDTHS = {"kernel": (32, 41, 256), "run-time codes": (32, 256),
          "wide lanes 16": (256,)}
SOURCES = ("fused_ops.cuh", "fused.cu", "fused_bwd.cu")


def build_variants(out_dir: str) -> dict:
    """(variant, "K5" | "K6") -> the loaded library, all built at once (one
    nvcc each), each variant in a directory of its own."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    texts = {}
    for name in SOURCES:
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = f.read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        files = dict(texts)
        for old, new in edits:
            hit = [fn for fn, body in files.items() if old in body]
            if not hit:
                raise RuntimeError(f"{name}: the sources no longer have "
                                   f"{old!r}")
            for fn in hit:
                files[fn] = files[fn].replace(old, new)
        d = os.path.join(out_dir, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for fname, body in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(body)
        for kname, src in (("K5", "fused.cu"), ("K6", "fused_bwd.cu")):
            lib = os.path.join(d, f"{kname}.so")
            procs[(name, kname)] = (lib, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", lib, os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, kname), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kname} {name}:\n{log}")
        libs[(name, kname)] = ctypes.CDLL(lib)
    print(f"built {len(libs)} libraries", flush=True)
    return libs


def launch_k5(lib, plan, g, deg, x, y, op):
    """One call of a K5 variant, as the wrapper ``fused`` makes it (a
    ragged K padded to a multiple of 4)."""
    from isplib_tpu_torch.kernels.fused import pad4, stage_codes, unpad
    fn = lib.fused_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    k = x.shape[1]
    x, y = pad4(x), pad4(y)
    out = torch.empty(plan.num_rows, x.shape[1], device=x.device)
    err = fn(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
             plan.seg_slot.data_ptr(), plan.split_rows.data_ptr(),
             g.col.data_ptr(), g.value.data_ptr(), deg.data_ptr(),
             x.data_ptr(), y.data_ptr(), out.data_ptr(), plan.nseg,
             plan.nsplit, x.shape[1], *stage_codes(op), x.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return unpad(out, k)


def launch_k6(lib, plan, col, val, x, y, gr, op, pass_b):
    """One call of a K6 variant's pass, as the wrapper ``fused_bwd``
    makes it (a ragged K padded to a multiple of 4)."""
    from isplib_tpu_torch.kernels.fused import pad4, stage_codes, unpad
    fn = lib.fused_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    k = x.shape[1]
    x, y, gr = pad4(x), pad4(y), pad4(gr)
    out = torch.empty(plan.num_rows, x.shape[1], device=x.device)
    err = fn(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
             plan.seg_slot.data_ptr(), plan.split_rows.data_ptr(),
             col.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(),
             gr.data_ptr(), out.data_ptr(), plan.nseg, plan.nsplit,
             x.shape[1], *stage_codes(op), int(pass_b), x.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return unpad(out, k)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_fused: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from isplib_tpu_torch import (FusedOp, Reduce, ReduceOp, ScalarOp,
                                  ScaleOp, VectorOp, build_tiling,
                                  graph_from_arrays)
    from isplib_tpu_torch.data import gen_rmat_graph
    from isplib_tpu_torch.kernels.fused import fused_plain
    from isplib_tpu_torch.kernels.fused_bwd import fused_bwd_plain

    print(cs.card_line(), flush=True)
    libs = build_variants(os.path.join(ROOT, "isplib_tpu_torch", "_build",
                                       "probe_fused"))
    g = graph_from_arrays(gen_rmat_graph(cs.RMAT_NODES, cs.RMAT_EDGES,
                                         cs.SEED, cs.EDGE_MULTIPLE), "cuda")
    tiled = build_tiling(g)
    n = g.nnz
    fwd, bwd = tiled.fwd_mm, tiled.bwd_mm
    print(f"rmat: {g.num_rows} nodes, {n} edges; {fwd.nseg} segments "
          f"({fwd.nsplit} split rows), Aᵀ {bwd.nseg} ({bwd.nsplit})",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.empty(g.nnz_padded, 2, device="cuda")
    for name in VARIANTS:
        if name == "scalar cache":
            libs[(name, "K6")].probe_set(
                ctypes.c_void_p(cache.data_ptr()),
                ctypes.c_void_p(g.csc2csr.data_ptr()))
    pipelines = {
        "sigmoid-embed": FusedOp(VectorOp.MUL, ReduceOp.DOT,
                                 ScalarOp.SIGMOID, ScaleOp.MUL, Reduce.SUM),
        "tdist-force": FusedOp(VectorOp.SUB, ReduceOp.NORM2, ScalarOp.TDIST,
                               ScaleOp.MUL, Reduce.SUM),
        "copy_rhs-mean": FusedOp.spmm("mean")}
    a_csr = cs.csr(g.rowptr, g.col[:n], g.value[:n]
                   / g.deg.clamp(min=1.0)[g.row[:n].long()], g.shape)
    at_csr = cs.csr(g.csc_colptr, g.csc_col[:n], g.csc_value[:n],
                    (g.num_cols, g.num_rows))

    def rel(got, want):
        """max |got - want| / max |want| (the absolute error where want
        is 0, as pass A's under COPY_RHS)."""
        return (float((got - want).abs().max())
                / (float(want.abs().max()) or 1.0))

    for k in (32, 41, 256):
        x = torch.randn(g.num_rows, k, device="cuda", generator=gen)
        y = torch.randn(g.num_cols, k, device="cuda", generator=gen)
        gr = torch.randn(g.num_rows, k, device="cuda", generator=gen)
        for pname, op in pipelines.items():
            gm = (gr / g.deg.clamp(min=1.0)[:, None]
                  if op.vsc is ScaleOp.MEAN else gr)
            want5 = fused_plain(fwd, g.col, g.value, g.deg, x, y, op)
            want_a = fused_bwd_plain(fwd, g.col, g.value, x, y, gm, op,
                                     False)
            want_b = fused_bwd_plain(bwd, g.csc_col, g.csc_value, x, y, gm,
                                     op, True)
            for name in VARIANTS:
                if k not in WIDTHS.get(name, (32,)):
                    continue
                k5, k6 = libs[(name, "K5")], libs[(name, "K6")]

                def fwd5(k5=k5, op=op, x=x, y=y):
                    return launch_k5(k5, fwd, g, g.deg, x, y, op)

                def pass_a(k6=k6, op=op, x=x, y=y, gm=gm):
                    return launch_k6(k6, fwd, g.col, g.value, x, y, gm, op,
                                     False)

                def pass_b(k6=k6, op=op, x=x, y=y, gm=gm):
                    return launch_k6(k6, bwd, g.csc_col, g.csc_value, x, y,
                                     gm, op, True)

                def both(pass_a=pass_a, pass_b=pass_b):
                    pass_a()
                    pass_b()

                e5 = rel(fwd5(), want5)
                ea, eb = rel(pass_a(), want_a), rel(pass_b(), want_b)
                print(f"{pname:13s} K={k:<3d} {name:20s} K5 "
                      f"{cs.cuda_ms(fwd5):.4f} ms (err {e5:.1e}); K6 pass A "
                      f"{cs.cuda_ms(pass_a):.4f} (err {ea:.1e}), pass B "
                      f"{cs.cuda_ms(pass_b):.4f} (err {eb:.1e}), both "
                      f"{cs.cuda_ms(both):.4f} ms", flush=True)
            if op.vsc is ScaleOp.MEAN:

                def lib5(y=y):
                    return torch.sparse.mm(a_csr, y)

                def lib6(gm=gm):
                    return torch.sparse.mm(at_csr, gm)

                def mean_g(gr=gr):
                    return gr / g.deg.clamp(min=1.0)[:, None]

                print(f"{pname:13s} K={k:<3d} torch.sparse.mm forward "
                      f"{cs.cuda_ms(lib5):.4f} ms (err "
                      f"{rel(lib5(), want5):.1e}), over Aᵀ "
                      f"{cs.cuda_ms(lib6):.4f} ms (err "
                      f"{rel(lib6(), want_b):.1e}); g / deg "
                      f"{cs.cuda_ms(mean_g):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
