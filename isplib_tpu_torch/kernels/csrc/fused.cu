// The FusedMM pipeline, accumulated by sum (isplib_tpu_torch.kernels.fused).
//
// Replaces the TPU kernel isplib_tpu/kernels/fused_pallas.py::_fused_kernel
// (entry fused_mm_tiled).  Same function: for every row r and every edge e
// of r with column c = col[e],
//     v_e = VOP(x[r], y[c])          per-edge vector (K)
//     t_e = ROP(v_e)                 sum or squared norm; 1 for NOOP
//     s_e = VSC(SOP(t_e))            x value, / max(deg[r], 1) for MEAN
//     out[r] += s_e * v_e            (v_e = y[c] for COPY_RHS)
// in fp32 throughout.  The TPU kernel scatters through a bf16 one-hot
// matmul and applies VSC_MEAN as a row post-scale; here every product is
// fp32 and MEAN divides per edge, as the XLA formulation does.  Under
// VSC_NONE a real edge of value 0 counts, as on the XLA path (the TPU
// kernel drops it); pad edges lie past the last segment and are never read.
//
// What bounds it on an H100: HBM bytes, namely col and val (8 B per edge),
// the segment list, the x rows (K*4 B per row, once per segment) and the
// gathered y rows (K*4 B per edge, from L2 when y fits in its 50 MB), and
// out; a few operations per edge and feature are far below the fp32 peak.
// The design is K1's skeleton (spmm_stream.cu): one warp per work item of
// at most SEG_EDGES edges of one row, lanes over K <= 256 (NK <= 8 floats a
// lane), x[r] in registers for the segment; col/val read 32 at a time,
// coalesced, and broadcast with shuffles.  Per edge: gather y[c], VOP,
// the ROP as a warp shuffle reduction, SOP and VSC on the warp-uniform
// scalar, and s * v into per-lane accumulators.  Masked lanes of a ragged K
// hold x = y = 0, so v = 0 and they add 0 to the reduction.  A row that is
// one segment stores its sum; the segments of a split row add theirs with
// atomicAdd into the zeroed output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_ops.cuh"

namespace {

using namespace fused;

constexpr int THREADS = 256;  // 8 warps, one work item each

template <int NK>
__global__ void __launch_bounds__(THREADS)
    fused_kernel(const int* __restrict__ seg_ptr,
                 const int* __restrict__ seg_row,
                 const int* __restrict__ seg_slot,
                 const int* __restrict__ col, const float* __restrict__ val,
                 const float* __restrict__ deg, const float* __restrict__ x,
                 const float* __restrict__ y, float* __restrict__ out,
                 int nseg, int k, int vop, int rop, int sop, int vsc) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int e0 = seg_ptr[item], e1 = seg_ptr[item + 1], r = seg_row[item];
  const float dr = vsc == VSC_MEAN ? fmaxf(deg[r], 1.f) : 1.f;

  float xr[NK], acc[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = lane + 32 * t;
    xr[t] = vop != COPY_RHS && f < k
                ? __ldg(x + static_cast<size_t>(r) * k + f) : 0.f;
    acc[t] = 0.f;
  }

  for (int eb = e0; eb < e1; eb += 32) {
    int c = 0;
    float w = 0.f;
    if (eb + lane < e1) {
      c = col[eb + lane];
      w = val[eb + lane];
    }
    const int m = min(32, e1 - eb);
#pragma unroll 2
    for (int jj = 0; jj < m; ++jj) {
      const int cj = __shfl_sync(FULL, c, jj);
      const float wj = __shfl_sync(FULL, w, jj);
      const float* yr = y + static_cast<size_t>(cj) * k;
      float v[NK];
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const int f = lane + 32 * t;
        const float yv = vop != COPY_LHS && f < k ? __ldg(yr + f) : 0.f;
        v[t] = vop_apply(vop, xr[t], yv);
        part += rop_part(rop, v[t]);
      }
      float s = rop == NOOP ? 1.f : warp_sum(part);
      if (sop != SOP_NONE) s = sop_apply(sop, s);
      if (vsc != VSC_NONE) s = s * wj / dr;
#pragma unroll
      for (int t = 0; t < NK; ++t) acc[t] = fmaf(s, v[t], acc[t]);
    }
  }

  float* o = out + static_cast<size_t>(r) * k;
  const bool whole = seg_slot[item] < 0;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = lane + 32 * t;
    if (f < k) {
      if (whole)
        o[f] = acc[t];
      else
        atomicAdd(o + f, acc[t]);
    }
  }
}

template <int NK>
int launch(const void* seg_ptr, const void* seg_row, const void* seg_slot,
           const void* col, const void* val, const void* deg, const void* x,
           const void* y, void* out, int nseg, int k, int vop, int rop,
           int sop, int vsc, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  fused_kernel<NK><<<(nseg + per_block - 1) / per_block, THREADS, 0,
                     stream>>>(
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_row),
      static_cast<const int*>(seg_slot), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(deg),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), nseg, k, vop, rop, sop, vsc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32, zeroed by the caller, = the sum-accumulated
// pipeline (vop, rop, sop, vsc: the codes of fused_ops.cuh) over the CSR
// edges (col, val) cut by the plan's segments, with x (num_rows, k), y
// (num_cols, k) and deg (num_rows,) fp32, k <= 256, on CUDA device `device`
// and stream `stream`.  Returns the CUDA error of the launch (0 = launched).
extern "C" int fused_launch(const void* seg_ptr, const void* seg_row,
                            const void* seg_slot, const void* col,
                            const void* val, const void* deg, const void* x,
                            const void* y, void* out, int nseg, int k,
                            int vop, int rop, int sop, int vsc, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_LAUNCH(NK)                                                    \
  return launch<NK>(seg_ptr, seg_row, seg_slot, col, val, deg, x, y, out,  \
                    nseg, k, vop, rop, sop, vsc, s)
  if (k <= 32) FUSED_LAUNCH(1);
  if (k <= 64) FUSED_LAUNCH(2);
  if (k <= 128) FUSED_LAUNCH(4);
  FUSED_LAUNCH(8);
#undef FUSED_LAUNCH
}
