// The lane layout that the edge-walking kernels share: fused.cu (K5) and
// fused_bwd.cu (K6) through fused_ops.cuh, spmm_stream.cu (K1) and
// sddmm.cu (K4).
//
// A warp walks one segment (<= SEG_EDGES edges of one row) and gives each
// edge a group of L lanes; each lane holds NV vectors of W consecutive
// features (float4, float2 or float: W = 4, 2 or 1, as the row pitch
// allows), lane q of a group vector t = features (t*L + q)*W + [0, W).  So
// at K = 32 a warp works on 8 edges at once, 4 lanes an edge and two
// float4 a lane: a per-edge reduction is a 2-step shuffle within the
// group, a per-edge scalar one instruction for the warp's 8 edges, and
// the groups' partial row sums combine once per segment.  Each group reads
// its own edge's column and value words, a round ahead of their use.  The
// gathers of D batches of edges (F floats a lane over the gathered rows)
// are issued before the arithmetic of the first.  probe_fused.py measured
// these choices (PERF.md): 4 lanes an edge against 2, 8, 16 and 32 at K =
// 32; the gathered floats each kernel keeps in flight against half and
// twice as many; the words ahead.
//
// A row's vectors past k read as 0 where the row holds no feature there:
// the callers give rows whose pitch is a multiple of W with zero columns
// past k (the wrappers pad a ragged K), or mask what lies past k.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace lanes {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // 8 warps, one segment each
// gathered floats in flight a lane, over every gathered row of a batch
// (K5's and K6's; K1 and K4 set their own)
constexpr int GATHER_FLOATS = 16;

// Batches of edges whose gathers are in flight at once, for NV vectors of W
// floats gathered per edge and F gathered floats a lane.
template <int W, int NV, int F = GATHER_FLOATS>
constexpr int DEPTH = F / (W * NV) > 0 ? F / (W * NV) : 1;

template <int W>
struct Vec {
  float f[W];
};

// Lane q's NV vectors of W floats of a row, 0 past k.
template <int W, int L, int NV>
struct Row {
  static_assert(W == 4 || W == 2 || W == 1, "float4, float2 or float");
  Vec<W> v[NV];

  __device__ __forceinline__ void load(const float* __restrict__ row, int q,
                                       int k) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int f = (t * L + q) * W;
      if (f < k) {
        if constexpr (W == 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(row + f));
          v[t].f[0] = a.x, v[t].f[1] = a.y, v[t].f[2] = a.z, v[t].f[3] = a.w;
        } else if constexpr (W == 2) {
          const float2 a = __ldg(reinterpret_cast<const float2*>(row + f));
          v[t].f[0] = a.x, v[t].f[1] = a.y;
        } else {
          v[t].f[0] = __ldg(row + f);
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) v[t].f[w] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < NV; ++t)
#pragma unroll
      for (int w = 0; w < W; ++w) v[t].f[w] = 0.f;
  }
};

// Sum over the L lanes of a group (xor offsets stay within the group).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The row's sum over the warp's 32 / L groups, left in every lane, then
// stored by group 0 (times `scale`) into the k features of `row`.  A row
// of one segment (`whole`) is written, or with ADD read, added to and
// written: one warp owns it.  A split row's segments add with atomicAdd
// (into a row their caller zeroed, or with ADD one that holds what they
// add to).  `vec`: the row takes W-wide vector stores (k % W == 0 and the
// row aligned to them), else each feature is stored alone and masked.
template <bool ADD = false, int W, int L, int NV>
__device__ __forceinline__ void store_row(Row<W, L, NV>& acc, float* row,
                                          int lane, int k, bool whole,
                                          float scale, bool vec = true) {
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        acc.v[t].f[w] += __shfl_xor_sync(FULL, acc.v[t].f[w], o);
  if (lane >= L) return;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int f = (t * L + lane) * W;
    if (f >= k) continue;
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
  }
}

// The column and weight (value, or 1 without `use_w`) of D batches of G
// edges from `base`, one edge a group; past `last` (the segment's last
// edge, or edge 0 for an empty segment) the word at `last`, which the
// caller masks.  The kernels fetch the next batches' words while the
// current ones' gathers are in flight.
template <int G, int D>
struct EdgeWords {
  int c[D];
  float w[D];

  __device__ __forceinline__ void fetch(const int* __restrict__ col,
                                        const float* __restrict__ val,
                                        bool use_w, int base, int last,
                                        int grp) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int e = min(base + d * G + grp, last);
      c[d] = __ldg(col + e);
      w[d] = use_w ? __ldg(val + e) : 1.f;
    }
  }
};

// The widest vector (4, 2 or 1 floats) that rows of pitch `ld` starting at
// each pointer of `ptrs` take.
__host__ inline int vec_width(int ld,
                             std::initializer_list<const void*> ptrs) {
  int w = ld % 4 == 0 ? 4 : ld % 2 == 0 ? 2 : 1;
  for (const void* p : ptrs)
    while (reinterpret_cast<uintptr_t>(p) % (4 * w)) w /= 2;
  return w;
}

}  // namespace lanes
