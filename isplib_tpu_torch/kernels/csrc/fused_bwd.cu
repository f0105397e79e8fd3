// Backward of the sum-accumulated FusedMM pipeline
// (isplib_tpu_torch.kernels.fused_bwd).
//
// Replaces the TPU kernel
// isplib_tpu/kernels/fused_pallas_bwd.py::_fused_bwd_kernel (entry
// fused_bwd_pass).  Same function, two passes: given the output cotangent
// g (num_rows, K) (for VSC_MEAN already divided by max(deg, 1), so MEAN
// scales like MUL here), each edge e = (i, j) recomputes
//     v = VOP(x[i], y[j]);  t = ROP(v);  s = SOP(t) * w   (w = val or 1)
// and applies the chain rule in registers:
//     a  = <g[i], v>                       (warp shuffle reduction)
//     ŝ  = a * w * SOP'(t)                 (0 for ROP = NOOP: t = 1 is fixed)
//     ĝv = s * g[i] + ŝ (DOT) or + 2 ŝ v (NORM2)
//     pass A: grad_x[i] += dVOP/dx * ĝv    walking the CSR (rows of A)
//     pass B: grad_y[j] += dVOP/dy * ĝv    walking the CSC (rows of Aᵀ)
// in fp32 throughout (the TPU kernel scatters through a bf16 one-hot
// matmul).  SOP' is compiled in for the catalogue (fused_ops.cuh), where
// the TPU kernel takes it from jax.vjp of the traced callable.  A tie of
// VOP max/min splits the cotangent 0.5 / 0.5, as the XLA formulation and
// torch autograd do; the TPU kernel gives all of it to one side.  No value
// cotangent: fused_mm sends a graph whose values require a gradient to the
// plain formulation.
//
// What bounds it on an H100: HBM bytes.  Pass A reads col and val (8 B per
// edge), x and g of each row once per segment, and a y row per edge; pass B
// reads the CSC's col and val, y of each row once per segment, and an x and
// a g row per edge (from L2 when they fit in its 50 MB).  About ten
// operations per edge and feature are far below the fp32 peak.  The design
// is K5's (fused.cu): one warp per <= SEG_EDGES-edge segment of one row,
// lanes over K <= 256 (NK <= 8 floats a lane), the segment row's operands in
// registers, per-lane accumulators, split rows added with atomicAdd into
// the zeroed output.  Masked lanes of a ragged K hold 0 in x, y and g, so
// they add 0 to both reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_ops.cuh"

namespace {

using namespace fused;

constexpr int THREADS = 256;  // 8 warps, one work item each

// pass_b = 0: the segments are rows i of A, col[e] = j, and the kernel
// emits grad_x.  pass_b = 1: the segments are rows j of Aᵀ (the CSC),
// col[e] = i, and it emits grad_y.
template <int NK>
__global__ void __launch_bounds__(THREADS)
    fused_bwd_kernel(const int* __restrict__ seg_ptr,
                     const int* __restrict__ seg_row,
                     const int* __restrict__ seg_slot,
                     const int* __restrict__ col,
                     const float* __restrict__ val,
                     const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ g, float* __restrict__ out,
                     int nseg, int k, int vop, int rop, int sop, int vsc,
                     int pass_b) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int e0 = seg_ptr[item], e1 = seg_ptr[item + 1], r = seg_row[item];

  // the segment row's operands: (x, g) in pass A, y in pass B
  float own_a[NK], own_g[NK], acc[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int f = lane + 32 * t;
    const size_t o = static_cast<size_t>(r) * k + f;
    own_a[t] = f < k ? __ldg((pass_b ? y : x) + o) : 0.f;
    own_g[t] = !pass_b && f < k ? __ldg(g + o) : 0.f;
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
      const float wj = vsc == VSC_NONE ? 1.f : __shfl_sync(FULL, w, jj);
      const size_t oc = static_cast<size_t>(cj) * k;
      float xv[NK], yv[NK], gv[NK], v[NK];
      float pt = 0.f, pa = 0.f;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const int f = lane + 32 * t;
        if (pass_b) {
          xv[t] = f < k ? __ldg(x + oc + f) : 0.f;
          gv[t] = f < k ? __ldg(g + oc + f) : 0.f;
          yv[t] = own_a[t];
        } else {
          xv[t] = own_a[t];
          gv[t] = own_g[t];
          yv[t] = f < k ? __ldg(y + oc + f) : 0.f;
        }
        v[t] = vop_apply(vop, xv[t], yv[t]);
        pt += rop_part(rop, v[t]);
        pa = fmaf(gv[t], v[t], pa);
      }
      float s = 1.f, shat = 0.f;
      if (rop != NOOP) {
        const float tt = warp_sum(pt);
        const float a = warp_sum(pa);
        s = tt;
        float ds = 1.f;
        if (sop != SOP_NONE) {
          s = sop_apply(sop, tt);
          ds = sop_grad(sop, s);
        }
        shat = a * wj * ds;
      } else if (sop != SOP_NONE) {
        s = sop_apply(sop, 1.f);
      }
      s *= wj;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        float d = s * gv[t];
        if (rop == DOT) d += shat;
        if (rop == NORM2) d += 2.f * shat * v[t];
        const float dv = pass_b ? vop_dy(vop, xv[t], yv[t])
                                : vop_dx(vop, xv[t], yv[t]);
        acc[t] = fmaf(dv, d, acc[t]);
      }
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
           const void* col, const void* val, const void* x, const void* y,
           const void* g, void* out, int nseg, int k, int vop, int rop,
           int sop, int vsc, int pass_b, cudaStream_t stream) {
  const int per_block = THREADS / 32;
  fused_bwd_kernel<NK><<<(nseg + per_block - 1) / per_block, THREADS, 0,
                         stream>>>(
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_row),
      static_cast<const int*>(seg_slot), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(g),
      static_cast<float*>(out), nseg, k, vop, rop, sop, vsc, pass_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One backward pass of the sum-accumulated pipeline (codes of
// fused_ops.cuh).  Pass A (pass_b = 0): the plan and (col, val) are the
// CSR's, out is grad_x (num_rows, k).  Pass B (pass_b = 1): the plan and
// (col, val) are the CSC's, out is grad_y (num_cols, k).  x (num_rows, k),
// y (num_cols, k) and g (num_rows, k) fp32, k <= 256; out zeroed by the
// caller; on CUDA device `device` and stream `stream`.  Returns the CUDA
// error of the launch (0 = launched).
extern "C" int fused_bwd_launch(const void* seg_ptr, const void* seg_row,
                                const void* seg_slot, const void* col,
                                const void* val, const void* x,
                                const void* y, const void* g, void* out,
                                int nseg, int k, int vop, int rop, int sop,
                                int vsc, int pass_b, int device,
                                void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_BWD_LAUNCH(NK)                                              \
  return launch<NK>(seg_ptr, seg_row, seg_slot, col, val, x, y, g, out,  \
                    nseg, k, vop, rop, sop, vsc, pass_b, s)
  if (k <= 32) FUSED_BWD_LAUNCH(1);
  if (k <= 64) FUSED_BWD_LAUNCH(2);
  if (k <= 128) FUSED_BWD_LAUNCH(4);
  FUSED_BWD_LAUNCH(8);
#undef FUSED_BWD_LAUNCH
}
