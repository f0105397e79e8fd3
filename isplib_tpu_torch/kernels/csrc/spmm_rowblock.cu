// Sum-SpMM over a v1 row-block plan (isplib_tpu_torch.kernels.spmm_rowblock).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_pallas.py::
// _spmm_rowblock_kernel (entry spmm_tiled).  Same function: for every real
// slot of the plan's chunks,
//     out[rb_ids[c]*rb + plane 0, k] += plane 2 * x[ct_ids[c]*ct + plane 1, k]
// in fp32 throughout.  The TPU kernel builds one-hot gather and scatter
// matrices per chunk and multiplies them on its matrix unit (in bf16 on the
// chip); none of that is carried over.
//
// What bounds it on an H100: the gathered x rows (K*4 B a real slot, served
// from L2 while the K tile's slice of x fits its 50 MB) and the latency of
// those gathers; the plan's planes are 12 B a slot and two operations per
// slot and feature are far below the fp32 peak.  The design this replaced
// (a CTA per run of 32 chunks and K tile of 32 or 64, each warp walking its
// slots one at a time with one x-row gather in flight, pads read and
// skipped, an rb x KT shared accumulator fed by shared atomics: 0.8103 ms
// at K = 32, 9.3745 ms at K = 602 on density-rep) waited on latency at 1-4%
// of bound.
//
// The design: rows are owned, and many gathers are in flight.  The plan's
// schedule (RowSchedule, derived once per plan) lists each row's real
// slots in order, one int32 a slot, so pads are never read, and cuts rows
// into work items of at most 256 slots.  A warp takes one item and one K
// tile of 32*NK features (up to 128, so K = 602 walks the slots five times
// where the old design walked them ten): its lanes read 32 slot indices at
// once and decode them (chunk, column, value) in parallel, then broadcast
// each slot with shuffles while the lanes run over features; the slot loop is
// unrolled eight deep with the gathers independent of the sums, so up to
// 8*NK x-row loads are in flight per warp.  The sum stays in registers and
// a row that is one item is stored once; the items of a split row (an
// R-MAT hub) add with atomicAdd into the zeroed output.  The grid's K tile
// is its slow index, so one tile's slice of x is what L2 holds at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one work item each
constexpr unsigned FULL = 0xffffffffu;

template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_rowblock_kernel(const int* __restrict__ edges,
                         const int* __restrict__ ct_ids,
                         const int* __restrict__ order,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ seg_ptr,
                         const int* __restrict__ seg_row,
                         const float* __restrict__ x, float* __restrict__ out,
                         int nseg, int eb, int ct, int k) {
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
    if (b + lane < e1) {  // decode this lane's slot
      const int q = order[b + lane];
      const int ch = q / eb, s = q - ch * eb;
      const int* e = edges + static_cast<size_t>(ch) * 3 * eb + s;
      c = __ldg(ct_ids + ch) * ct + __ldg(e + eb);
      v = __int_as_float(__ldg(e + 2 * eb));
    }
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
      if (whole)
        o[f] = acc[t];
      else
        atomicAdd(o + f, acc[t]);
    }
  }
}

template <int NK>
int launch(const void* edges, const void* ct_ids, const void* order,
           const void* row_ptr, const void* seg_ptr, const void* seg_row,
           const void* x, void* out, int nseg, int eb, int ct, int k,
           cudaStream_t stream) {
  const int per_block = THREADS / 32;
  const dim3 grid((nseg + per_block - 1) / per_block,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_rowblock_kernel<NK><<<grid, THREADS, 0, stream>>>(
      static_cast<const int*>(edges), static_cast<const int*>(ct_ids),
      static_cast<const int*>(order), static_cast<const int*>(row_ptr),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_row),
      static_cast<const float*>(x), static_cast<float*>(out), nseg, eb, ct,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32, zeroed by the caller, = the plan's edges times x
// (num_cols, k) fp32, walking the plan's schedule, on CUDA device `device`
// and stream `stream`.  K tiles of 32, 64, 96 or 128 features (1-4 a lane).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int spmm_rowblock_launch(const void* edges, const void* ct_ids,
                                    const void* order, const void* row_ptr,
                                    const void* seg_ptr, const void* seg_row,
                                    const void* x, void* out, int nseg,
                                    int eb, int ct, int k, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    return launch<1>(edges, ct_ids, order, row_ptr, seg_ptr, seg_row, x, out,
                     nseg, eb, ct, k, s);
  if (k <= 64)
    return launch<2>(edges, ct_ids, order, row_ptr, seg_ptr, seg_row, x, out,
                     nseg, eb, ct, k, s);
  if (k <= 96)
    return launch<3>(edges, ct_ids, order, row_ptr, seg_ptr, seg_row, x, out,
                     nseg, eb, ct, k, s);
  return launch<4>(edges, ct_ids, order, row_ptr, seg_ptr, seg_row, x, out,
                   nseg, eb, ct, k, s);
}
