// The walk that the two row-owning sum kernels share: spmm_rowblock.cu
// (K10, the v1 row-block plan) and spmm_v2.cu (K8, the v2 cell plan).
//
// Both compute out[r, f] (+)= the sum of val * x[col, f] over row r's real
// slots, in fp32, over a schedule that the plan layer derives once per plan
// (RowSchedule in isplib_tpu_torch/sparse/tiling.py, RowScheduleV2 in
// tiling_v2.py): each row's real slots as flat indices chunk*eb + slot (pads
// never listed), and the rows cut into work items of at most 256 (K10) or 64
// (K8) slots.  They differ only in how a slot decodes: the order of a chunk's
// planes and where a chunk's column offset comes from, which a slot decoder
// says (V1Slots for K10, V2Slots for K8).
//
// What bounds it on an H100: the gathered x rows (K*4 B a real slot,
// served from L2 while the K tile's slice of x fits its 50 MB) and the
// latency of those gathers; the plan's planes are 8 B a slot read here (4
// more for its index) and two operations per slot and feature are far
// below the fp32 peak.
//
// The design: rows are owned, and many gathers are in flight.  A warp
// takes one item and one K tile of 32*NK features (up to 128 for K10, 160
// for K8, so K = 602 walks the slots five or four times): its lanes read
// 32 slot indices at once and decode them (column, value) in parallel,
// then broadcast each slot with shuffles while the lanes run over
// features; the slot loop is unrolled
// eight deep with the gathers independent of the sums, so up to 8*NK
// x-row loads are in flight per warp.  The sum stays in registers; a row
// that is one item is stored once (or, with ADD, read, added and stored:
// one warp owns it), and the items of a split row (an R-MAT hub) add with
// atomicAdd into an output whose row the caller zeroed (or, with ADD,
// holds what is added to).  The grid's K tile is its slow index, so one
// tile's slice of x is what L2 holds at a time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowwalk {

constexpr int THREADS = 256;  // 8 warps, one work item each
constexpr unsigned FULL = 0xffffffffu;

// K10's slots: planes 0, 1, 2 are row, column, value; chunk ch's columns
// start at ct_ids[ch] * ct.
struct V1Slots {
  const int* edges;
  const int* ct_ids;
  int eb, ct;

  __device__ __forceinline__ void decode(int q, int& c, float& v) const {
    const int ch = q / eb, s = q - ch * eb;
    const int* e = edges + static_cast<size_t>(ch) * 3 * eb + s;
    c = __ldg(ct_ids + ch) * ct + __ldg(e + eb);
    v = __int_as_float(__ldg(e + 2 * eb));
  }
};

// K8's slots: planes 0, 1, 2 are column, value, row; chunk ch's columns
// start at chunk_col[ch], the schedule's per-chunk offset.
struct V2Slots {
  const int* edges;
  const int* chunk_col;
  int eb;

  __device__ __forceinline__ void decode(int q, int& c, float& v) const {
    const int ch = q / eb, s = q - ch * eb;
    const int* e = edges + static_cast<size_t>(ch) * 3 * eb + s;
    c = __ldg(chunk_col + ch) + __ldg(e);
    v = __int_as_float(__ldg(e + eb));
  }
};

template <int NK, bool ADD, class S>
__global__ void __launch_bounds__(THREADS)
    walk_kernel(const S slots, const int* __restrict__ order,
                const int* __restrict__ row_ptr,
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

  for (int b = e0; b < e1; b += 32) {
    int c = 0;
    float v = 0.f;
    if (b + lane < e1) slots.decode(order[b + lane], c, v);  // this lane's
    const int m = min(32, e1 - b);
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const int cj = __shfl_sync(FULL, c, j);
      const float vj = __shfl_sync(FULL, v, j);
      const float* xr = x + static_cast<size_t>(cj) * k;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const int f = f0 + 32 * t;
        if (f < k) acc[t] = fmaf(vj, __ldg(xr + f), acc[t]);
      }
    }
  }

  const bool whole = e0 == row_ptr[r] && e1 == row_ptr[r + 1];
  float* o = out + static_cast<size_t>(r) * k;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = f0 + 32 * t;
    if (f < k) {
      if (!whole)
        atomicAdd(o + f, acc[t]);
      else if (ADD)
        o[f] += acc[t];
      else
        o[f] = acc[t];
    }
  }
}

template <int NK, bool ADD, class S>
int launch_walk(const S& slots, const void* order, const void* row_ptr,
                const void* seg_ptr, const void* seg_row, const void* x,
                void* out, int nseg, int k, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  const dim3 grid((nseg + per_block - 1) / per_block,
                  (k + 32 * NK - 1) / (32 * NK));
  walk_kernel<NK, ADD, S><<<grid, THREADS, 0, stream>>>(
      slots, static_cast<const int*>(order),
      static_cast<const int*>(row_ptr), static_cast<const int*>(seg_ptr),
      static_cast<const int*>(seg_row), static_cast<const float*>(x),
      static_cast<float*>(out), nseg, k);
  return static_cast<int>(cudaGetLastError());
}

// out (num_rows, k) fp32 (+)= the schedule's slots times x (num_cols, k)
// fp32 on `stream`, slots decoded as `slots` says: ADD adds every row's
// sum into out, else a row of one item is stored and a split row added
// (the caller zeroes those rows first).  K is walked in the fewest passes
// of at most 32*MAX_NK features, each as narrow as that many passes allow
// (K = 602: five passes of 128 at MAX_NK = 4, four of 160 at 5).  Returns
// the CUDA error of the launch (0 = launched).
template <bool ADD, int MAX_NK, class S>
int run(const S& slots, const void* order, const void* row_ptr,
        const void* seg_ptr, const void* seg_row, const void* x, void* out,
        int nseg, int k, cudaStream_t stream) {
  static_assert(MAX_NK >= 4 && MAX_NK <= 5, "K tiles of 128 or 160");
  const int lanes = (k + 31) / 32;  // features a lane takes over all of K
  if (lanes == 0) return 0;
  const int passes = (lanes + MAX_NK - 1) / MAX_NK;
  switch ((lanes + passes - 1) / passes) {
    case 1:
      return launch_walk<1, ADD>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                 out, nseg, k, stream);
    case 2:
      return launch_walk<2, ADD>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                 out, nseg, k, stream);
    case 3:
      return launch_walk<3, ADD>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                 out, nseg, k, stream);
    case 4:
      return launch_walk<4, ADD>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                 out, nseg, k, stream);
  }
  if constexpr (MAX_NK == 5)
    return launch_walk<5, ADD>(slots, order, row_ptr, seg_ptr, seg_row, x,
                               out, nseg, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rowwalk
