#!/usr/bin/env python3
"""Attribute the time of the kernels on the lane layout on one CUDA card:
where do K5 (``isplib_tpu_torch/kernels/csrc/fused.cu``), the two passes of
K6 (``fused_bwd.cu``), K1 (``spmm_stream.cu``) and K4 (``sddmm.cu``), which
share ``lane_layout.cuh`` (K5 and K6 through ``fused_ops.cuh``), spend it?

    python3 probe_fused.py

Builds copies of the kernels with parts cut out or changed, each with the
port's nvcc flags into ``isplib_tpu_torch/_build/probe_fused/`` (all at
once, one nvcc a source); K5 and K6 for every variant, K1 and K4 where
the variant says so:

* earlier: K1 and K4 as they were before they took the lane layout (a warp
  per segment, a lane per feature, each edge's words broadcast by
  shuffles, 4 edges unrolled, K4 reducing every edge's dot over the whole
  warp), and the layout's row load and store as K5 and K6 had them (float4
  rows only, no add mode);
* no gathers (all four): the gathered rows (y in K5 and pass A, x and g
  in pass B, x in K1, b in K4) replaced by values made from the column
  index, no load;
* no ROP shuffles: the group reductions of t (and of a in K6) cut out;
* lanes per edge 2, 8, 16 or 32 at K <= 32, where the kernels take 4 with
  two float4 a lane (four float4 a lane at 2; one float4, float2 or float
  at 8, 16 or 32); K1 and K4 at 2 and 8;
* gathers halved or doubled (all four): half or twice the gathered floats
  a lane that each kernel keeps in flight (K5 and K6 16, at K = 32 2
  batches of 8 edges; K1 8; K4 32);
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
* K4 stores gathered (K4 alone): each lane collects the dots of 32
  consecutive edges by shuffles and stores once, where the kernel's groups
  store their dots as they come (32 / L consecutive edges at once);
* K4 tiles of 128 (K4 alone, K = 602): K tiles of 128 features (32 lanes
  of 4 floats), the grid's slow index, whose partial dots add with
  atomicAdd, where the kernel holds K <= 640 in one tile;
* K=41 on 4 lanes (K1 and K4, K = 41): 4 lanes of 12 floats an edge at
  32 < K <= 48, where the kernels take 8 lanes of 8 floats;

and times every variant with CUDA events.  K5 and K6 on ``chip_smoke.py``'s
R-MAT graph (``scripts/bench_fused.py``'s ``gen_rmat_graph(11648, 5730794,
crc32("reddit"), 4096)``) for the sigmoid embedding kernel, the
t-distribution force model and COPY_RHS + MEAN at K = 32 (the kernel and
the earlier header also at 41, padded to 44 as the wrappers pad it, and
256; the run-time codes also at 256, wide lanes at 256 alone), beside
``torch.sparse.mm`` where one call computes the function (COPY_RHS + MEAN:
A with the mean's values times y, and Aᵀ with the CSC values times g) and
the division of g by the degree that ``FusedMM.backward`` makes for MEAN.
K1 on the residual edges of ``chip_smoke.py``'s density-representative
graph (its ``auto_tile`` plans of A and Aᵀ), K4 on that graph and the R-MAT
graph, every K1/K4 variant at K = 32 (K4 tiles of 128 at 602 alone, K=41 on
4 lanes at 41 alone), the kernel, the earlier design and the gathers halved
or doubled also at 41 and 602; at K = 41 the kernel and K=41 on 4 lanes as
the wrapper calls them (the padded copy made in the timed call), on
operands already padded to 44 (float4 loads), padded to 42 (float2) and
unpadded (float).  The kernel and the earlier design are timed in turns
(earlier, kernel, kernel, earlier), each turn printed.  A variant that cuts
work out computes garbage: only the whole kernel's error against the plain
version is meaningful; it is printed for every variant.  The registers and
spills of the kernel's and the earlier design's instances are printed where
they differ (K5, K6) or in full (K1, K4).  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
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
# K1's and K4's layout at 16 < K <= 32: 4 lanes of 8 floats
_K32_14 = "  if (a.k <= 32) return launch<W, 4, 8>(a, s);"
_K64_14 = "  if (a.k <= 64) return launch<W, 8, 8>(a, s);"
_GF = "constexpr int GATHER_FLOATS = 16;"  # K5's and K6's
_GK1 = "constexpr int GATHERED = 8;"  # K1's
_GK4 = "constexpr int GATHERED = 32;"  # K4's
_NEXT = ("    if (b + G * D < e1) nxt.fetch(a.col, a.val, use_w, b + G * D, "
         "last, grp);\n")
_SW = ("      float sw = s_one * cur.w[d], shat = 0.f;\n"
       "      if (rop != NOOP) {")
_SHAT = "        shat = pa * cur.w[d] * sop_grad(sop, s);\n      }"
# the lane layout's row load and row store as the earlier header had them
# (float4 rows, write or atomic add), and the earlier K1 and K4 (their
# sources, comments left out)
_LOAD_NEW = """\
        if constexpr (W == 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(row + f));
          v[t].f[0] = a.x, v[t].f[1] = a.y, v[t].f[2] = a.z, v[t].f[3] = a.w;
        } else if constexpr (W == 2) {
          const float2 a = __ldg(reinterpret_cast<const float2*>(row + f));
          v[t].f[0] = a.x, v[t].f[1] = a.y;
        } else {
          v[t].f[0] = __ldg(row + f);
        }
"""
_LOAD_EARLIER = """\
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + f));
        v[t].f[0] = a.x, v[t].f[1] = a.y, v[t].f[2] = a.z, v[t].f[3] = a.w;
"""
_STORE_NEW = """\
    float* p = row + f;
    float (&s)[W] = acc.v[t].f;
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] *= scale;
    if (!whole) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (vec || f + w < k) atomicAdd(p + w, s[w]);
    } else if (!vec) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (f + w < k) p[w] = ADD ? p[w] + s[w] : s[w];
    } else if constexpr (W == 4) {
      float4* p4 = reinterpret_cast<float4*>(p);
      if constexpr (ADD) {
        const float4 o = *p4;
        s[0] += o.x, s[1] += o.y, s[2] += o.z, s[3] += o.w;
      }
      *p4 = make_float4(s[0], s[1], s[2], s[3]);
    } else if constexpr (W == 2) {
      float2* p2 = reinterpret_cast<float2*>(p);
      if constexpr (ADD) {
        const float2 o = *p2;
        s[0] += o.x, s[1] += o.y;
      }
      *p2 = make_float2(s[0], s[1]);
    } else {
      p[0] = ADD ? p[0] + s[0] : s[0];
    }
"""
_STORE_EARLIER = """\
#pragma unroll
    for (int w = 0; w < W; ++w) acc.v[t].f[w] *= scale;
    if (!whole) {
#pragma unroll
      for (int w = 0; w < W; ++w) atomicAdd(row + f + w, acc.v[t].f[w]);
    } else {
      *reinterpret_cast<float4*>(row + f) = make_float4(
          acc.v[t].f[0], acc.v[t].f[1], acc.v[t].f[2], acc.v[t].f[3]);
    }
"""
EARLIER_SOURCES = {"spmm_stream.cu": r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one work item each
constexpr unsigned FULL = 0xffffffffu;

template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_stream_kernel(const int* __restrict__ rowptr,
                       const int* __restrict__ col,
                       const float* __restrict__ val,
                       const int* __restrict__ seg_ptr,
                       const int* __restrict__ seg_row,
                       const float* __restrict__ x, float* __restrict__ out,
                       int nseg, int k) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * 32 * NK + lane;
  const int e0 = seg_ptr[item], e1 = seg_ptr[item + 1], r = seg_row[item];

  float acc[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) acc[t] = 0.f;

  for (int eb = e0; eb < e1; eb += 32) {
    int c = 0;
    float v = 0.f;
    if (eb + lane < e1) {
      c = col[eb + lane];
      v = val[eb + lane];
    }
    const int m = min(32, e1 - eb);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      const int cj = __shfl_sync(FULL, c, jj);
      const float vj = __shfl_sync(FULL, v, jj);
      const float* xr = x + static_cast<size_t>(cj) * k;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const int f = f0 + 32 * t;
        if (f < k) acc[t] = fmaf(vj, __ldg(xr + f), acc[t]);
      }
    }
  }

  const bool whole = e0 == rowptr[r] && e1 == rowptr[r + 1];
  float* o = out + static_cast<size_t>(r) * k;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = f0 + 32 * t;
    if (f < k) {
      if (whole)
        o[f] += acc[t];
      else
        atomicAdd(o + f, acc[t]);
    }
  }
}

template <int NK>
int launch(const void* rowptr, const void* col, const void* val,
           const void* seg_ptr, const void* seg_row, const void* x, void* out,
           int nseg, int k, void* stream) {
  const int per_block = THREADS / 32;
  const dim3 grid((nseg + per_block - 1) / per_block,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_stream_kernel<NK><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(seg_row), static_cast<const float*>(x),
      static_cast<float*>(out), nseg, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spmm_stream_launch(const void* rowptr, const void* col,
                                  const void* val, const void* seg_ptr,
                                  const void* seg_row, const void* x,
                                  void* out, int nseg, int k, int device,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 32)
    return launch<1>(rowptr, col, val, seg_ptr, seg_row, x, out, nseg, k,
                     stream);
  if (k <= 64)
    return launch<2>(rowptr, col, val, seg_ptr, seg_row, x, out, nseg, k,
                     stream);
  if (k <= 96)
    return launch<3>(rowptr, col, val, seg_ptr, seg_row, x, out, nseg, k,
                     stream);
  return launch<4>(rowptr, col, val, seg_ptr, seg_row, x, out, nseg, k,
                   stream);
}
""", "sddmm.cu": r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one work item each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int NK>
__global__ void __launch_bounds__(THREADS)
    sddmm_kernel(const int* __restrict__ seg_ptr,
                 const int* __restrict__ seg_row, const int* __restrict__ col,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int nseg, int k) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int e0 = seg_ptr[item], e1 = seg_ptr[item + 1];
  const float* ar = a + static_cast<size_t>(seg_row[item]) * k;
  const bool one_chunk = k <= 32 * NK;

  float areg[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = lane + 32 * t;
    areg[t] = f < k ? __ldg(ar + f) : 0.f;
  }

  for (int eb = e0; eb < e1; eb += 32) {
    const int c = eb + lane < e1 ? col[eb + lane] : 0;
    const int m = min(32, e1 - eb);
    float mine = 0.f;
    for (int k0 = 0; k0 < k; k0 += 32 * NK) {
      if (!one_chunk) {
#pragma unroll
        for (int t = 0; t < NK; ++t) {
          const int f = k0 + lane + 32 * t;
          areg[t] = f < k ? __ldg(ar + f) : 0.f;
        }
      }
#pragma unroll 4
      for (int jj = 0; jj < m; ++jj) {
        const float* br =
            b + static_cast<size_t>(__shfl_sync(FULL, c, jj)) * k + k0;
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < NK; ++t) {
          const int f = lane + 32 * t;
          if (k0 + f < k) part = fmaf(areg[t], __ldg(br + f), part);
        }
        part = warp_sum(part);
        if (lane == jj) mine += part;
      }
    }
    if (eb + lane < e1) out[eb + lane] = mine;
  }
}

template <int NK>
int launch(const void* seg_ptr, const void* seg_row, const void* col,
           const void* a, const void* b, void* out, int nseg, int k,
           cudaStream_t stream) {
  const int per_block = THREADS / 32;
  sddmm_kernel<NK><<<(nseg + per_block - 1) / per_block, THREADS, 0,
                     stream>>>(
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_row),
      static_cast<const int*>(col), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(out), nseg, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sddmm_launch(const void* seg_ptr, const void* seg_row,
                            const void* col, const void* a, const void* b,
                            void* out, int nseg, int k, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch<1>(seg_ptr, seg_row, col, a, b, out, nseg, k, s);
  if (k <= 64) return launch<2>(seg_ptr, seg_row, col, a, b, out, nseg, k, s);
  if (k <= 128) return launch<4>(seg_ptr, seg_row, col, a, b, out, nseg, k, s);
  return launch<8>(seg_ptr, seg_row, col, a, b, out, nseg, k, s);
}
"""}
_K4_STORE = """\
      const float dot = group_sum<L>(part);
      const int e = b + d * G + grp;
      if (q == 0 && e < e1) {
        if (tiled)
          atomicAdd(a.out + e, dot);
        else
          a.out[e] = dot;
      }
"""
# lane j takes the dot of edge e0 + 32 * window + j from the group that
# holds it; the warp stores a window when it is full or the segment ends
_K4_STORE_GATHERED = """\
      const float dot = group_sum<L>(part);
      const int rel = b + d * G - e0, s0 = rel % 32;
      const float got = __shfl_sync(FULL, dot, ((lane - s0) & (G - 1)) * L);
      if (lane >= s0 && lane < s0 + G) mine = got;
      if (s0 + G == 32 || b + d * G + G >= e1) {
        const int e = e0 + rel - s0 + lane;
        if (e < e1) {
          if (tiled)
            atomicAdd(a.out + e, mine);
          else
            a.out[e] = mine;
        }
      }
"""
# (old, new) edits of the sources, each applied wherever its old text is
VARIANTS = {
    "kernel": [],
    "earlier": [(_LOAD_NEW, _LOAD_EARLIER), (_STORE_NEW, _STORE_EARLIER)],
    "no gathers": [
        _FAKE,
        ("yv[d].load(a.y + static_cast<size_t>(cur.c[d]) * k, q, k);",
         "yv[d].fake(cur.c[d]);"),
        ("ov[d].load((PASS_B ? a.x : a.y) + oc, q, k);",
         "ov[d].fake(cur.c[d]);"),
        ("if constexpr (PASS_B) gv[d].load(a.g + oc, q, k);",
         "if constexpr (PASS_B) gv[d].fake(cur.c[d] + 1);"),
        ("xv[d].load(x + static_cast<size_t>(cur.c[d]) * a.ldx, q, kt);",
         "xv[d].fake(cur.c[d]);"),
        ("bv[d].load(bk + static_cast<size_t>(cur.c[d]) * a.ld, q, kt);",
         "bv[d].fake(cur.c[d]);")],
    "no ROP shuffles": [("for (int o = L / 2; o > 0; o >>= 1)",
                         "for (int o = 0; o > 0; o >>= 1)")],
    "lanes 2": [(_K32, _K32.replace("<4, 4, 2,", "<4, 2, 4,")),
                (_K32_14, _K32_14.replace("<W, 4, 8>", "<W, 2, 16>"))],
    "lanes 8": [(_K32, _K32.replace("<4, 4, 2,", "<4, 8, 1,")),
                (_K32_14, _K32_14.replace("<W, 4, 8>", "<W, 8, 4>"))],
    "lanes 16": [(_K32, _K32.replace("<4, 4, 2,", "<2, 16, 1,"))],
    "lanes 32": [(_K32, _K32.replace("<4, 4, 2,", "<1, 32, 1,"))],
    "gathers halved": [(_GF, _GF.replace("16", "8")),
                       (_GK1, _GK1.replace("8", "4")),
                       (_GK4, _GK4.replace("32", "16"))],
    "gathers doubled": [(_GF, _GF.replace("16", "32")),
                        (_GK1, _GK1.replace("8", "16")),
                        (_GK4, _GK4.replace("32", "64"))],
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
    "K=41 on 4 lanes": [(_K64_14, "  if (a.k <= 48) return launch<W, 4, 12>"
                                   "(a, s);\n" + _K64_14)],
    "K4 tiles of 128": [(
        "  return launch<W, 32, 20, 2 * GATHERED>(a, s);",
        "  return launch<W, 32, 4>(a, s);")],
    "K4 stores gathered": [
        ("  EdgeWords<G, D> nxt;\n  nxt.fetch(a.col, nullptr,",
         "  float mine = 0.f;  // the dot of edge e0 + 32 * window + lane\n"
         "  EdgeWords<G, D> nxt;\n  nxt.fetch(a.col, nullptr,"),
        (_K4_STORE, _K4_STORE_GATHERED)],
}

# the widths each variant is timed at on K5 and K6 (the rest at K = 32
# only; the earlier design with the kernel)
WIDTHS = {"kernel": (32, 41, 256), "run-time codes": (32, 256),
          "wide lanes 16": (256,)}
SOURCES = ("lane_layout.cuh", "fused_ops.cuh", "fused.cu", "fused_bwd.cu",
           "spmm_stream.cu", "sddmm.cu")
KERNEL_SOURCES = {"K5": "fused.cu", "K6": "fused_bwd.cu",
                  "K1": "spmm_stream.cu", "K4": "sddmm.cu"}
# the kernels each variant builds (the rest: K5 and K6)
ALL = ("K1", "K4", "K5", "K6")
BUILDS = {"kernel": ALL, "earlier": ALL, "no gathers": ALL, "lanes 2": ALL,
          "lanes 8": ALL, "gathers halved": ALL, "gathers doubled": ALL,
          "K4 stores gathered": ("K4",), "K4 tiles of 128": ("K4",),
          "K=41 on 4 lanes": ("K1", "K4")}
K14_KS = (32, 41, 602)  # K1's and K4's widths
# the widths each variant is timed at on K1 and K4 (the rest at K = 32)
K14_WIDTHS = {"kernel": K14_KS, "earlier": K14_KS,
              "gathers halved": K14_KS, "gathers doubled": K14_KS,
              "K4 tiles of 128": (602,),
              "K=41 on 4 lanes": (41,)}
# the variants whose loads at an odd K are timed (padded in the call and
# before, float2 and float loads)
ODD_K = ("kernel", "K=41 on 4 lanes")


def build_variants(out_dir: str) -> tuple[dict, dict]:
    """(variant, "K1" | "K4" | "K5" | "K6") -> the loaded library, all
    built at once (one nvcc each), each variant in a directory of its own;
    and the same keys -> the nvcc report."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    texts = {}
    for name in SOURCES:
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = f.read()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        files = dict(texts)
        if name == "earlier":
            files.update(EARLIER_SOURCES)
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
        for kname in BUILDS.get(name, ("K5", "K6")):
            lib = os.path.join(d, f"{kname}.so")
            procs[(name, kname)] = (lib, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", lib,
                 os.path.join(d, KERNEL_SOURCES[kname])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for (name, kname), (lib, proc) in procs.items():
        logs[(name, kname)], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kname} {name}:\n"
                               f"{logs[(name, kname)]}")
        libs[(name, kname)] = ctypes.CDLL(lib)
    print(f"built {len(libs)} libraries", flush=True)
    return libs, logs


def print_registers(logs: dict) -> None:
    """The kernel's and the earlier design's registers and spills per
    instance: K1 and K4 in full, K5 and K6 where the two differ."""
    for kname in ALL:
        new = dict(cs.ptxas_report(logs[("kernel", kname)]))
        old = dict(cs.ptxas_report(logs[("earlier", kname)]))
        for fn in sorted(set(new) | set(old)):
            if kname in ("K1", "K4") or new.get(fn) != old.get(fn):
                print(f"ptxas {kname} {fn}: kernel {new.get(fn)}; earlier "
                      f"{old.get(fn)}", flush=True)


def turns(old, new, **kw) -> str:
    """The earlier design and the kernel timed in turns (earlier, kernel,
    kernel, earlier)."""
    t = [cs.cuda_ms(f, **kw) for f in (old, new, new, old)]
    ratio = (t[1] + t[2]) / (t[0] + t[3])
    return (f"earlier {t[0]:.4f} / {t[3]:.4f}, kernel {t[1]:.4f} / "
            f"{t[2]:.4f} ms (kernel / earlier {ratio:.3f})")


def padded(t: torch.Tensor, pitch: int) -> torch.Tensor:
    """t as a view of a copy with row pitch ``pitch``, zeros past K."""
    tp = t.new_zeros(t.shape[0], pitch)
    tp[:, :t.shape[1]] = t
    return tp[:, :t.shape[1]]


def launch_k1(lib, plan, x, out, earlier=False):
    """One call of a K1 variant, out += residual edges @ x, with x as
    given (its row pitch read; the earlier kernel reads pitch K)."""
    fn = lib.spmm_stream_launch
    ints = [plan.nseg, x.shape[1]] + ([] if earlier else [x.stride(0)])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * (len(ints) + 1) \
        + [ctypes.c_void_p]
    err = fn(*(t.data_ptr() for t in (
        plan.res_rowptr, plan.res_col, plan.res_val, plan.seg_ptr,
        plan.seg_row, x, out)), *ints, x.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def launch_k4(lib, plan, col, a, b, out, earlier=False):
    """One call of a K4 variant into ``out`` (zeroed once, by the caller),
    with a and b as given (one row pitch)."""
    fn = lib.sddmm_launch
    ints = [plan.nseg, a.shape[1]] + ([] if earlier else [a.stride(0)])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (len(ints) + 1) \
        + [ctypes.c_void_p]
    err = fn(*(t.data_ptr() for t in (plan.seg_ptr, plan.seg_row, col, a, b,
                                      out)), *ints, a.device.index,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def rel(got, want):
    """max |got - want| / max |want| (the absolute error where want is 0,
    as pass A's under COPY_RHS)."""
    return (float((got - want).abs().max())
            / (float(want.abs().max()) or 1.0))


def probe_k1_k4(libs, rmat, gen) -> None:
    """K1 on density-rep's residual edges (A and Aᵀ), K4 on density-rep
    and the R-MAT graph: every variant at K = 32, the kernel and the
    earlier design at K14_KS, the kernel's K = 41 loads."""
    from isplib_tpu_torch import graph_from_arrays
    from isplib_tpu_torch.data import gen_gcnsig_graph
    from isplib_tpu_torch.kernels.minmax_walk import pitched
    from isplib_tpu_torch.kernels.sddmm import sddmm_plain
    from isplib_tpu_torch.kernels.spmm_stream import spmm_stream_oracle
    from isplib_tpu_torch.sparse.tiling import auto_tile

    _, nodes, edges, seed = cs.graph_specs()[1]
    gd = graph_from_arrays(gen_gcnsig_graph(
        nodes, edges, cs.CLASSES, cs.FEATURES, seed, cs.EDGE_MULTIPLE),
        "cuda")
    td = auto_tile(gd)
    print(f"density-rep: {gd.num_rows} nodes, {gd.nnz} edges; residual "
          f"{td.fwd.sparse_edges} edges in {td.fwd.nseg} segments, Aᵀ "
          f"{td.bwd.sparse_edges} in {td.bwd.nseg}", flush=True)
    k1s = [n for n in VARIANTS if "K1" in BUILDS.get(n, ())]
    k4s = [n for n in VARIANTS if "K4" in BUILDS.get(n, ())]
    for (direction, plan), k in [(c, k) for c in (("fwd", td.fwd),
                                                  ("bwd", td.bwd))
                                 for k in K14_KS]:
        x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
        out = torch.zeros(plan.num_rows, k, device="cuda")
        want = spmm_stream_oracle(plan, x, out).float()
        xp = pitched(x)

        def run(name, x=xp, out=out):
            return lambda: launch_k1(libs[(name, "K1")], plan, x, out)

        def old(out=out, x=x):
            return launch_k1(libs[("earlier", "K1")], plan, x, out,
                             earlier=True)

        def wrapper(out=out, x=x):  # the wrapper's call: the copy inside
            return launch_k1(libs[("kernel", "K1")], plan, pitched(x), out)

        tag = f"K1 density-rep {direction} K={k:<3d}"
        for name in k1s:
            if k not in K14_WIDTHS.get(name, (32,)):
                continue
            out.zero_()
            (old if name == "earlier" else run(name))()
            err = rel(out, want)
            if name not in ("kernel", "earlier"):
                print(f"{tag} {name:20s} {cs.cuda_ms(run(name)):.4f} ms "
                      f"(err {err:.1e})", flush=True)
            else:
                print(f"{tag} {name:20s} err {err:.1e}", flush=True)
        print(f"{tag} {turns(old, wrapper)}", flush=True)
        for name, label, xv in [(n, *c) for n in ODD_K for c in (
                ("padded in the call", None),
                ("padded before (float4)", xp),
                (f"pitch {k + 1} (float2)", padded(x, k + 1)),
                ("unpadded (float)", x))] if k % 2 else []:
            f = (run(name, xv) if xv is not None else
                 lambda name=name, out=out, x=x: launch_k1(
                     libs[(name, "K1")], plan, pitched(x), out))
            out.zero_()
            f()
            err = rel(out, want)
            print(f"{tag} {name} {label}: {cs.cuda_ms(f):.4f} ms (err "
                  f"{err:.1e})", flush=True)
        del x, out, want, xp

    for (gname, g, plan), k in [(c, k) for c in (
            ("density-rep", gd, td.fwd_mm),
            ("rmat", rmat[0], rmat[1].fwd_mm)) for k in K14_KS]:
        a = torch.randn(g.num_rows, k, device="cuda", generator=gen)
        b = torch.randn(g.num_cols, k, device="cuda", generator=gen)
        want = sddmm_plain(plan, g.col, a, b)
        out = torch.zeros_like(want)
        ap, bp = pitched(a), pitched(b)

        def run(name, a=ap, b=bp, out=out, g=g, plan=plan):
            return lambda: launch_k4(libs[(name, "K4")], plan, g.col, a, b,
                                     out)

        def old(a=a, b=b, out=out, g=g, plan=plan):
            return launch_k4(libs[("earlier", "K4")], plan, g.col, a, b, out,
                             earlier=True)

        def wrapper(a=a, b=b, out=out, g=g, plan=plan):
            return launch_k4(libs[("kernel", "K4")], plan, g.col, pitched(a),
                             pitched(b), out)

        tag = f"K4 {gname:11s} K={k:<3d}"
        for name in k4s:
            if k not in K14_WIDTHS.get(name, (32,)):
                continue
            out.zero_()
            (old if name == "earlier" else run(name))()
            err = rel(out, want)
            if name not in ("kernel", "earlier"):
                print(f"{tag} {name:20s} {cs.cuda_ms(run(name)):.4f} ms "
                      f"(err {err:.1e})", flush=True)
            else:
                print(f"{tag} {name:20s} err {err:.1e}", flush=True)
        print(f"{tag} {turns(old, wrapper)}", flush=True)
        for name, label, av, bv in [(n, *c) for n in ODD_K for c in (
                ("padded in the call", None, None),
                ("padded before (float4)", ap, bp),
                (f"pitch {k + 1} (float2)", padded(a, k + 1),
                 padded(b, k + 1)),
                ("unpadded (float)", a, b))] if k % 2 else []:
            f = (run(name, av, bv) if av is not None else
                 lambda name=name, a=a, b=b, out=out, g=g, plan=plan:
                 launch_k4(libs[(name, "K4")], plan, g.col, pitched(a),
                           pitched(b), out))
            out.zero_()
            f()
            err = rel(out, want)
            print(f"{tag} {name} {label}: {cs.cuda_ms(f):.4f} ms (err "
                  f"{err:.1e})", flush=True)
        del a, b, want, out, ap, bp


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
    libs, logs = build_variants(os.path.join(ROOT, "isplib_tpu_torch",
                                             "_build", "probe_fused"))
    print_registers(logs)
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

    def calls(name, op, x, y, gm):
        """K5, K6 pass A and K6 pass B of a variant."""
        k5, k6 = libs[(name, "K5")], libs[(name, "K6")]
        return (lambda: launch_k5(k5, fwd, g, g.deg, x, y, op),
                lambda: launch_k6(k6, fwd, g.col, g.value, x, y, gm, op,
                                  False),
                lambda: launch_k6(k6, bwd, g.csc_col, g.csc_value, x, y, gm,
                                  op, True))

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
                if (k not in WIDTHS.get(name, (32,)) or name == "earlier"
                        or "K5" not in BUILDS.get(name, ("K5",))):
                    continue
                fwd5, pass_a, pass_b = calls(name, op, x, y, gm)

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
                if name != "kernel":
                    continue
                old = calls("earlier", op, x, y, gm)
                errs = [rel(f(), w) for f, w in zip(old, (want5, want_a,
                                                          want_b))]
                for label, f_old, f_new, err in zip(
                        ("K5", "K6 pass A", "K6 pass B"), old,
                        (fwd5, pass_a, pass_b), errs):
                    print(f"{pname:13s} K={k:<3d} {label:9s} "
                          f"{turns(f_old, f_new)}; earlier err {err:.1e}",
                          flush=True)
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
    del x, y, gr, gm, want5, want_a, want_b, cache
    probe_k1_k4(libs, (g, tiled), gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
