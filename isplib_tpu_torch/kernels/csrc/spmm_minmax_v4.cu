// Max/min SpMM with the winning edge id per (row, feature)
// (isplib_tpu_torch.kernels.spmm_minmax_v4).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_minmax_v4.py::_v4mm_kernel
// (entry spmm_minmax_v4).  Same function: for every row r and feature k,
//     out[r, k] = max_{e in row r} val[e] * x[col[e], k]
//     arg[r, k] = the lowest edge id e that attains it
// and for min the same on the negated products.  It is exact fp32 (one
// multiply and one compare per edge and feature, no sum), and out is the
// winning edge's own product, so the result equals the plain version bit for
// bit.  Empty rows give out = 0 and arg = sentinel (nnz_padded - 1, a pad
// edge through which no gradient flows).  An edge's id is its CSR position:
// the kernel reads the graph's own col and val, no copy of the edges.
//
// What bounds it on an H100: HBM bytes, namely col + val (8 B per edge), the
// segment list, the gathered x rows (K*4 B per distinct source row; from L2
// when x fits in its 50 MB, from HBM at K = 602 on the sparser graph) and
// out + arg (8 B per row and feature); two operations per edge and feature
// are far below the fp32 peak.  The design is K1's (spmm_stream.cu): one
// warp per work item of at most SEG_EDGES edges of one row, lanes over K
// (NK features each, a grid-y axis of feature tiles for wide K, the ragged
// K masked per lane), col/val read 32 at a time, coalesced, and broadcast
// with shuffles.  Each lane keeps a (value, id) pair per feature in
// registers and walks its segment's edges in ascending id, replacing only on
// a strict '>': that alone gives the lowest id on ties.
//
// A row that is one segment writes out and arg directly; an empty row has
// one empty segment, so every row is written by this kernel.  The segments
// of a split row (R-MAT hubs of 10^4+ edges, whose segments run in no order)
// meet in a zeroed 64-bit scratch through atomicMax on the key of
// minmax_key.cuh (ordered value, then the lower id; the two zeros tie).  A
// second kernel decodes each split row's key into arg and recomputes
// out = val[arg] * x[col[arg], k].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "minmax_key.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, one work item each
constexpr unsigned FULL = 0xffffffffu;

// NK: features per lane; a warp covers 32*NK features starting at k0.
template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_minmax_kernel(const int* __restrict__ col,
                       const float* __restrict__ val,
                       const int* __restrict__ seg_ptr,
                       const int* __restrict__ seg_row,
                       const int* __restrict__ seg_slot,
                       const float* __restrict__ x, float* __restrict__ out,
                       int* __restrict__ arg,
                       unsigned long long* __restrict__ scratch, int nseg,
                       int k, float sgn, int sentinel) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * 32 * NK + lane;
  const int e0 = seg_ptr[item], e1 = seg_ptr[item + 1], r = seg_row[item];

  float best[NK];
  int id[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    best[t] = -INFINITY;
    id[t] = -1;
  }

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
        if (f < k) {
          // sgn * p is exact, so sgn * best is the winner's own product
          const float w = sgn * __fmul_rn(vj, __ldg(xr + f));
          if (w > best[t] || id[t] < 0) {
            best[t] = w;
            id[t] = eb + jj;
          }
        }
      }
    }
  }

  const int slot = seg_slot[item];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = f0 + 32 * t;
    if (f >= k) continue;
    if (slot < 0) {
      const size_t o = static_cast<size_t>(r) * k + f;
      out[o] = id[t] < 0 ? 0.f : sgn * best[t];
      arg[o] = id[t] < 0 ? sentinel : id[t];
    } else {  // a segment of a split row is never empty
      atomicMax(scratch + static_cast<size_t>(slot) * k + f,
                minmax_key(best[t], id[t]));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    decode_split_rows(const int* __restrict__ col,
                      const float* __restrict__ val,
                      const int* __restrict__ split_rows,
                      const float* __restrict__ x,
                      const unsigned long long* __restrict__ scratch,
                      float* __restrict__ out, int* __restrict__ arg,
                      int nsplit, int k) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<size_t>(nsplit) * k) return;
  const int s = static_cast<int>(i / k), f = static_cast<int>(i % k);
  const int e = minmax_key_id(scratch[i]);
  const size_t o = static_cast<size_t>(split_rows[s]) * k + f;
  out[o] = __fmul_rn(val[e], x[static_cast<size_t>(col[e]) * k + f]);
  arg[o] = e;
}

template <int NK>
int launch(const void* col, const void* val, const void* seg_ptr,
           const void* seg_row, const void* seg_slot, const void* split_rows,
           const void* x, void* out, void* arg, void* scratch, int nseg,
           int nsplit, int k, int negate, int sentinel, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  const dim3 grid((nseg + per_block - 1) / per_block,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_minmax_kernel<NK><<<grid, THREADS, 0, stream>>>(
      static_cast<const int*>(col), static_cast<const float*>(val),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_row),
      static_cast<const int*>(seg_slot), static_cast<const float*>(x),
      static_cast<float*>(out), static_cast<int*>(arg),
      static_cast<unsigned long long*>(scratch), nseg, k,
      negate ? -1.f : 1.f, sentinel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 0) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(nsplit) * k;
  decode_split_rows<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                      THREADS, 0, stream>>>(
      static_cast<const int*>(col), static_cast<const float*>(val),
      static_cast<const int*>(split_rows), static_cast<const float*>(x),
      static_cast<const unsigned long long*>(scratch),
      static_cast<float*>(out), static_cast<int*>(arg), nsplit, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32 and arg (num_rows, k) int32 = max (negate = 0) or
// min (negate = 1) SpMM of the CSR (col, val) cut by the plan's segments,
// times x (num_cols, k) fp32, on CUDA device `device` and stream `stream`.
// `scratch` is (nsplit, k) uint64, zeroed by the caller.  Returns the CUDA
// error of the launches (0 = launched).
extern "C" int spmm_minmax_launch(const void* col, const void* val,
                                  const void* seg_ptr, const void* seg_row,
                                  const void* seg_slot,
                                  const void* split_rows, const void* x,
                                  void* out, void* arg, void* scratch,
                                  int nseg, int nsplit, int k, int negate,
                                  int sentinel, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    return launch<1>(col, val, seg_ptr, seg_row, seg_slot, split_rows, x, out,
                     arg, scratch, nseg, nsplit, k, negate, sentinel, s);
  if (k <= 64)
    return launch<2>(col, val, seg_ptr, seg_row, seg_slot, split_rows, x, out,
                     arg, scratch, nseg, nsplit, k, negate, sentinel, s);
  if (k <= 96)
    return launch<3>(col, val, seg_ptr, seg_row, seg_slot, split_rows, x, out,
                     arg, scratch, nseg, nsplit, k, negate, sentinel, s);
  return launch<4>(col, val, seg_ptr, seg_row, seg_slot, split_rows, x, out,
                   arg, scratch, nseg, nsplit, k, negate, sentinel, s);
}
