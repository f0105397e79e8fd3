// Sampled dense-dense product (SDDMM) over the CSR edges
// (isplib_tpu_torch.kernels.sddmm).
//
// Replaces the TPU kernel isplib_tpu/kernels/sddmm_pallas.py::_sddmm_kernel
// (entries sddmm_tiled, sddmm_dots_tiled).  Same function: for every real
// edge e of row r and column c = col[e],
//     out[e] = <a[r, :], b[c, :]>
// in fp32, written at the edge's CSR position (its id), so no eid_pos
// scatter follows as on the TPU.  Pad edges are never visited: the caller
// zeroes out.
//
// What bounds it on an H100: HBM bytes, namely col and out (8 B per edge),
// the segment list, and the a and b rows (K*4 B per distinct row; gathered
// per edge from L2 when they fit in its 50 MB, as at the main path's
// widths); two operations per edge and feature are far below the fp32 peak.
// The design is K1's (spmm_stream.cu): one warp per work item of at most
// SEG_EDGES edges of one row, lanes over K (NK features each).  a[r] is
// loaded once per segment into registers (for K <= 32*NK; a wider K walks
// chunks of 32*NK features and reloads each chunk per 32 edges).  col is
// read 32 edges at a time, coalesced, and broadcast with shuffles; per edge
// the lanes read b[c] coalesced, multiply, and reduce with __shfl_xor_sync;
// the lane whose edge it is keeps the dot and writes it, 32 edges per
// coalesced store.  Masked lanes of a ragged K add 0.

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

// NK: features per lane; a warp covers 32*NK features per chunk.
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

// out[e] = <a[row e], b[col e]> for the CSR edges cut by the plan's
// segments; a (num_rows, k) and b (num_cols, k) fp32, on CUDA device
// `device` and stream `stream`.  Returns the CUDA error of the launch
// (0 = launched).
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
