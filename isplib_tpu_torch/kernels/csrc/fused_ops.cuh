// The FusedMM pipeline's stages, shared by fused.cu (K5) and fused_bwd.cu
// (K6).  The codes are the declaration order of VectorOp, ReduceOp and
// ScaleOp in isplib_tpu_torch/ops/semiring.py, and for the SOP 0 = none,
// then the order of ScalarOp (the catalogue the kernels compile in).  Every
// stage is a warp-uniform runtime integer, so one instantiation per NK
// serves all 7*3*3*3 pipelines.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fused {

enum Vop { COPY_RHS = 0, COPY_LHS, ADD, SUB, MUL, VMAX, VMIN };
enum Rop { NOOP = 0, DOT, NORM2 };
enum Sop { SOP_NONE = 0, SIGMOID, TDIST };
enum Vsc { VSC_MUL = 0, VSC_MEAN, VSC_NONE };

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float vop_apply(int op, float x, float y) {
  switch (op) {
    case COPY_RHS: return y;
    case COPY_LHS: return x;
    case ADD: return x + y;
    case SUB: return x - y;
    case MUL: return x * y;
    case VMAX: return fmaxf(x, y);
    default: return fminf(x, y);
  }
}

// d VOP / dx and d VOP / dy.  A tie of max/min splits the cotangent 0.5 /
// 0.5, as the plain formulation's autograd (torch.maximum) and the JAX
// package's XLA path (jnp.maximum) do.
__device__ __forceinline__ float vop_dx(int op, float x, float y) {
  switch (op) {
    case COPY_RHS: return 0.f;
    case MUL: return y;
    case VMAX: return x > y ? 1.f : (x == y ? 0.5f : 0.f);
    case VMIN: return x < y ? 1.f : (x == y ? 0.5f : 0.f);
    default: return 1.f;  // COPY_LHS, ADD, SUB
  }
}

__device__ __forceinline__ float vop_dy(int op, float x, float y) {
  switch (op) {
    case COPY_LHS: return 0.f;
    case SUB: return -1.f;
    case MUL: return x;
    case VMAX: return y > x ? 1.f : (x == y ? 0.5f : 0.f);
    case VMIN: return y < x ? 1.f : (x == y ? 0.5f : 0.f);
    default: return 1.f;  // COPY_RHS, ADD
  }
}

// The ROP's per-lane part; the warp sums it.
__device__ __forceinline__ float rop_part(int op, float v) {
  return op == NORM2 ? v * v : v;
}

__device__ __forceinline__ float sop_apply(int op, float t) {
  switch (op) {
    case SIGMOID: return 1.f / (1.f + expf(-t));
    case TDIST: return 1.f / (1.f + t);
    default: return t;
  }
}

// d SOP / dt, from t's image s = SOP(t).
__device__ __forceinline__ float sop_grad(int op, float s) {
  switch (op) {
    case SIGMOID: return s * (1.f - s);
    case TDIST: return -(s * s);
    default: return 1.f;
  }
}

}  // namespace fused
