// The walk that the two max/min kernels share: spmm_minmax_v4.cu (K3, over
// the graph's CSR) and spmm_minmax.cu (K7, over a with-eids v2 cell plan).
//
// Both compute, for every row r and feature f,
//     out[r, f] = max over the edges e of row r of val[e] * x[col[e], f]
//     arg[r, f] = the lowest edge id that attains it
// (min: the same on the negated products), exact fp32, with 0 and the
// sentinel for rows without edges.  They walk a schedule that the plan
// layer derives once per plan (MinMaxSchedule in
// isplib_tpu_torch/sparse/minmax_sched.py) and differ only in how an edge
// decodes and how the winner's value is written, which an edge decoder
// says (CsrEdges for K3, V2Edges for K7 in their sources).
//
// What bounds it on an H100: the instructions per edge and feature (a
// multiply, a compare and two selects) and the x rows each edge reads (K*4
// B an edge, from L2 while x fits its 50 MB); the edges' words and the
// outputs are the HBM bytes.  A warp owns a work item of the schedule (at
// most N edges of one row) and a K tile.  Its lanes decode 32 edges at once
// and broadcast them with shuffles (the next 32 fetched while the warp
// walks these); the warp is G groups of L lanes, each group takes every
// G-th edge, each lane V-wide vectors of x (float4, float2 or float as x's
// row pitch allows: the wrappers pad an odd K to a multiple of 4), and
// LOADS_IN_FLIGHT vector loads a lane are issued before their compares.
// The groups' winners meet by shuffles at the end of the item; a row of one
// item is stored once.  A staged mode (a block-row's x tiles copied into
// shared memory by cp.async, warps walking its edges from there) trailed
// this walk 3-9x on every case probe_minmax.py measured, where x fits L2,
// and is not part of it: the probe keeps it as a patched copy.
//
// One tie rule everywhere: a candidate (w, e) replaces (best, id) when
// w > best, or w == best and e < id; so -0.0 and +0.0 tie and the lower id
// wins.  The schedule lists a row's edges by id, so within a lane's run of
// edges the rule is a strict '>'; runs meet under the whole rule.  The
// sign of min is folded into the edge value: (-v) * x is -(v * x) exactly.
// A row whose edges are cut over several items (split) meets in a scratch
// of only those rows through atomicMax on the key of minmax_key.cuh (the
// same order), and a last pass decodes only those rows.  A pre-pass writes
// 0 and the sentinel into the rows without edges and zeroes the scratch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "minmax_key.cuh"

namespace mmwalk {

constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NO_ID = 0x7fffffff;  // (best, id) of no candidate: (-inf, NO_ID)
constexpr int LOADS_IN_FLIGHT = 4;  // vector loads a lane issues ahead
                                    // (8, 16: probe_minmax.py)
constexpr unsigned FULL = 0xffffffffu;
using u64 = unsigned long long;

// The schedule and operands of one call (laid out as the wrappers'
// ctypes.Structure in isplib_tpu_torch/kernels/minmax_walk.py).
struct Args {
  const int* order;      // refs by (row, id), or null: items are ref ranges
  const int* items;      // (nseg, 3): lo, hi, row
  const int* row_slot;   // (num_rows,): scratch row of a split row, or -1
  const int* split_rows; // (nsplit,)
  const int* zero_rows;  // (nzero,): rows without edges
  const float* x;        // (num_cols, ldx)
  float* out;            // (num_rows, k)
  int* arg;              // (num_rows, k)
  u64* scratch;          // (nsplit, k)
  int nseg, nsplit, nzero;
  int num_rows, num_cols, k, ldx, negate, sentinel;
};

// the tie rule, where two runs of edges meet
__device__ __forceinline__ bool better(float w, int e, float best, int id) {
  return w > best || (w == best && e < id);
}

// the tie rule within a run of edges that come in ascending id (as the
// schedule lists a row's edges): a strict '>' keeps the lowest id
__device__ __forceinline__ bool beats(float w, float best, int id) {
  return w > best || id == NO_ID;
}

// ---- the pre-pass: rows without edges, and the scratch -------------------
__global__ void __launch_bounds__(THREADS) prep_kernel(Args a) {
  const size_t nz = static_cast<size_t>(a.nzero) * a.k;
  const size_t ns = static_cast<size_t>(a.nsplit) * a.k;
  const size_t stride = static_cast<size_t>(gridDim.x) * THREADS;
  for (size_t q = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
       q < nz || q < ns; q += stride) {
    if (q < nz) {
      const size_t o = static_cast<size_t>(a.zero_rows[q / a.k]) * a.k +
                       q % a.k;
      a.out[o] = 0.f;
      a.arg[o] = a.sentinel;
    }
    if (q < ns) a.scratch[q] = 0ull;
  }
}

// ---- the last pass: the split rows' keys ---------------------------------
template <class D>
__global__ void __launch_bounds__(THREADS) decode_kernel(const D dec,
                                                         Args a) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<size_t>(a.nsplit) * a.k) return;
  const int s = static_cast<int>(i / a.k), f = static_cast<int>(i % a.k);
  const u64 key = a.scratch[i];
  const size_t o = static_cast<size_t>(a.split_rows[s]) * a.k + f;
  a.out[o] = key ? dec.from_key(key, f, a.x, a.ldx, a.negate ? -1.f : 1.f)
                 : 0.f;
  a.arg[o] = key ? minmax_key_id(key) : a.sentinel;
}

// the winner of one (row, feature): stored, or combined into the scratch
// (no candidate, where every product was NaN: 0 and the sentinel)
template <class D>
__device__ __forceinline__ void put(const D& dec, const Args& a, int slot,
                                    int r, int f, float best, int id,
                                    float sgn) {
  if (slot < 0) {
    const size_t o = static_cast<size_t>(r) * a.k + f;
    a.out[o] = id == NO_ID ? 0.f : dec.final(best, sgn);
    a.arg[o] = id == NO_ID ? a.sentinel : id;
  } else if (id != NO_ID) {
    atomicMax(a.scratch + static_cast<size_t>(slot) * a.k + f,
              minmax_key(best, id));
  }
}

template <int V>
struct Vec {
  float f[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.f[0] = q.x, r.f[1] = q.y, r.f[2] = q.z, r.f[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    r.f[0] = q.x, r.f[1] = q.y;
  } else {
    r.f[0] = __ldg(p);
  }
  return r;
}

// ---- the walk ------------------------------------------------------------
// A warp: G = 32 / L groups of L lanes; a lane's features are NV vectors of
// V floats, vector t at k0 + (s + L*t)*V (s = its lane in the group), so a
// K tile is KT = L*NV*V features.  `a` is __grid_constant__, so the
// lambda below takes it by reference in parameter space: as a plain
// parameter, ptxas's code for this kernel changed with Args's size (a
// smaller Args ran K3 ~5% slower on an H100, by probe_minmax.py).
template <class D, int V, int L, int NV>
__global__ void __launch_bounds__(THREADS) gather_kernel(
    const D dec, const __grid_constant__ Args a) {
  constexpr int G = 32 / L;
  constexpr int KT = L * NV * V;
  constexpr int U = NV >= LOADS_IN_FLIGHT ? 1 : LOADS_IN_FLIGHT / NV;
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= a.nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31, grp = lane / L, sub = lane % L;
  const int k0 = blockIdx.y * KT;
  const int lo = a.items[3 * item], hi = a.items[3 * item + 1];
  const int r = a.items[3 * item + 2];
  const float sgn = a.negate ? -1.f : 1.f;

  float best[NV][V];
  int id[NV][V];
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      best[t][i] = -INFINITY;
      id[t][i] = NO_ID;
    }

  // this lane's edge of the batch at b (its words are fetched a batch ahead)
  auto fetch = [&](int b, int& c, float& v, int& e) {
    c = 0, v = 0.f, e = NO_ID;
    if (b + lane < hi) {
      dec.edge(a.order ? __ldg(a.order + b + lane) : b + lane, c, v, e);
      v *= sgn;
    }
  };
  int c, e;
  float v;
  fetch(lo, c, v, e);
  for (int b = lo; b < hi; b += 32) {
    int cn, en;
    float vn;
    fetch(b + 32, cn, vn, en);
    const int m = min(32, hi - b);
    const int rounds = (m + G - 1) / G;
    for (int j0 = 0; j0 < rounds; j0 += U) {
      Vec<V> xv[U][NV];
      float vj[U];
      int ej[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = grp + G * (j0 + u);
        const int cj = __shfl_sync(FULL, c, src & 31);
        vj[u] = __shfl_sync(FULL, v, src & 31);
        ej[u] = __shfl_sync(FULL, e, src & 31);
        ok[u] = j0 + u < rounds && src < m;
        const float* xr = a.x + static_cast<size_t>(cj) * a.ldx;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int f = k0 + (sub + L * t) * V;
          if (ok[u] && f < a.k) xv[u][t] = load_vec<V>(xr + f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if (k0 + (sub + L * t) * V >= a.k) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float w = __fmul_rn(vj[u], xv[u][t].f[i]);
            if (beats(w, best[t][i], id[t][i])) {
              best[t][i] = w;
              id[t][i] = ej[u];
            }
          }
        }
      }
    }
    c = cn, v = vn, e = en;
  }

  // the groups' winners meet
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < NV; ++t)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float w = __shfl_xor_sync(FULL, best[t][i], o);
        const int e = __shfl_xor_sync(FULL, id[t][i], o);
        if (better(w, e, best[t][i], id[t][i])) {
          best[t][i] = w;
          id[t][i] = e;
        }
      }
  if (grp != 0) return;
  const int slot = a.row_slot[r];
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int f = k0 + (sub + L * t) * V + i;
      if (f < a.k) put(dec, a, slot, r, f, best[t][i], id[t][i], sgn);
    }
}

// ---- launches ----------------------------------------------------------------
template <class D, int V, int L, int NV>
cudaError_t launch_gather(const D& dec, const Args& a, cudaStream_t st) {
  constexpr int KT = L * NV * V;
  const dim3 grid((a.nseg + WARPS - 1) / WARPS, (a.k + KT - 1) / KT);
  gather_kernel<D, V, L, NV><<<grid, THREADS, 0, st>>>(dec, a);
  return cudaGetLastError();
}

// L lanes a group: the fewest (at least 4) whose 4 floats a lane cover K,
// else 32 in K tiles of 128 (8 floats a lane, tiles of 256, were slower at
// K = 602: probe_minmax.py)
template <class D, int V>
cudaError_t gather(const D& dec, const Args& a, cudaStream_t st) {
  if (a.k > 64) return launch_gather<D, V, 32, 4 / V>(dec, a, st);
  if (a.k > 32) return launch_gather<D, V, 16, 4 / V>(dec, a, st);
  if (a.k > 16) return launch_gather<D, V, 8, 4 / V>(dec, a, st);
  return launch_gather<D, V, 4, 4 / V>(dec, a, st);
}

// out and arg (num_rows, k) = the max/min walk of the schedule in `a`, on
// `stream`: the pre-pass, the walk, the split rows' decode.  x's row pitch
// ldx and its address set the vector width (float4, float2 or float).
// Returns the CUDA error of the launches (0 = launched).
template <class D>
int run(const D& dec, const Args& a, cudaStream_t st) {
  if (a.k <= 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.x);
  const size_t n = static_cast<size_t>(a.nzero > a.nsplit ? a.nzero
                                                           : a.nsplit) * a.k;
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    size_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    prep_kernel<<<static_cast<int>(blocks), THREADS, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (a.nseg > 0) {
    if (a.ldx % 4 == 0 && p % 16 == 0)
      err = gather<D, 4>(dec, a, st);
    else if (a.ldx % 2 == 0 && p % 8 == 0)
      err = gather<D, 2>(dec, a, st);
    else
      err = gather<D, 1>(dec, a, st);
  }
  if (err != cudaSuccess || a.nsplit == 0) return static_cast<int>(err);
  const size_t nd = static_cast<size_t>(a.nsplit) * a.k;
  decode_kernel<D><<<static_cast<unsigned>((nd + THREADS - 1) / THREADS),
                     THREADS, 0, st>>>(dec, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mmwalk
