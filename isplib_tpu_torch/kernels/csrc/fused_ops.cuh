// The FusedMM pipeline's stages, shared by fused.cu (K5) and fused_bwd.cu
// (K6), so that the two kernels cannot drift apart; both walk the lane
// layout of lane_layout.cuh (an edge per group of L lanes, float4 rows:
// the wrappers pad a ragged K with zero features to a multiple of 4, which
// makes every row 16-byte aligned), the ROP a log2(L)-step shuffle within
// the group, the SOP (on MUFU: probe_fused.py) and VSC one instruction for
// the warp's 32 / L edges.  The codes are the declaration order of
// VectorOp, ReduceOp and ScaleOp in isplib_tpu_torch/ops/semiring.py, and
// for the SOP 0 = none, then the order of ScalarOp (the catalogue the
// kernels compile in).
//
// The VOP is decoded once per segment against the segment row's own
// operand ("own": x in the forward and backward pass A, y in pass B) into
// per-feature coefficients, so inside the edge loop the five linear VOPs
// are one FMA a feature, v = A*other + B, and their derivative with respect
// to own one FMA, a_own + c*other; max/min keep A = sgn*own and take
// v = sgn*max(A, sgn*other) (min(x, y) = -max(-x, -y), exact).  The ROP
// and SOP are template parameters for linear VOPs above K = 16, the set
// the kernels instantiate: the 9 combinations, where ROP = NOOP reads its
// SOP at run time (t = 1, so the SOP is evaluated once a segment); every
// other pipeline (max/min VOPs, K <= 16) runs the same kernel bodies
// instantiated with the codes read at run time (ROP = SOP = RUNTIME).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane_layout.cuh"

namespace fused {

using namespace lanes;

enum Vop { COPY_RHS = 0, COPY_LHS, ADD, SUB, MUL, VMAX, VMIN };
enum Rop { NOOP = 0, DOT, NORM2 };
enum Sop { SOP_NONE = 0, SIGMOID, TDIST };
enum Vsc { VSC_MUL = 0, VSC_MEAN, VSC_NONE };

constexpr int RUNTIME = -1;  // a stage template parameter read at run time

// The rows rows[0, n) of out (., k) set to 0: the split rows, before the
// segments add into them.
static __global__ void __launch_bounds__(THREADS)
    zero_rows_kernel(const int* __restrict__ rows, float* __restrict__ out,
                     int n, int k) {
  const size_t total = static_cast<size_t>(n) * k;
  const size_t stride = static_cast<size_t>(gridDim.x) * THREADS;
  for (size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < total; i += stride)
    out[static_cast<size_t>(rows[i / k]) * k + i % k] = 0.f;
}

static __host__ int zero_rows(const void* rows, void* out, int n, int k,
                              cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t total = static_cast<size_t>(n) * k;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  zero_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const int*>(rows), static_cast<float*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

// ---- the stages ---------------------------------------------------------

// The VOP seen from the segment row's side: v = ax*x + ay*y + c*x*y for
// COPY_RHS, COPY_LHS, ADD, SUB, MUL, or max/min.  A zero coefficient never
// multiplies an operand, so an operand the VOP does not read (say x under
// COPY_RHS, which may hold anything) never reaches the result.
struct VopSide {
  float a_own, b_oth, c, sgn;
  bool mm, need_other;

  __device__ __forceinline__ VopSide(int vop, bool own_is_y) {
    float ax = 0.f, ay = 0.f;
    c = 0.f;
    sgn = vop == VMIN ? -1.f : 1.f;
    mm = vop == VMAX || vop == VMIN;
    switch (vop) {
      case COPY_RHS: ay = 1.f; break;
      case COPY_LHS: ax = 1.f; break;
      case ADD: ax = ay = 1.f; break;
      case SUB: ax = 1.f, ay = -1.f; break;
      case MUL: c = 1.f; break;
      default: break;
    }
    a_own = own_is_y ? ay : ax;
    b_oth = own_is_y ? ax : ay;
    need_other = mm || b_oth != 0.f || c != 0.f;
  }

  // Per-feature coefficients against own: v = A*other + B (linear), or
  // A = sgn*own (max/min).
  __device__ __forceinline__ void coef(float own, float& A, float& B) const {
    if (mm) {
      A = sgn * own, B = 0.f;
    } else {
      A = c != 0.f ? fmaf(c, own, b_oth) : b_oth;
      B = a_own != 0.f ? a_own * own : 0.f;
    }
  }

  template <bool MM>
  __device__ __forceinline__ float apply(float A, float B, float o) const {
    if (MM && mm) return sgn * fmaxf(A, sgn * o);
    return fmaf(A, o, B);
  }

  // d VOP / d own.  A tie of max/min splits the cotangent 0.5 / 0.5, as the
  // plain formulation's autograd (torch.maximum) and the JAX package's XLA
  // path (jnp.maximum) do.
  template <bool MM>
  __device__ __forceinline__ float d_own(float A, float o) const {
    if (MM && mm) {
      const float so = sgn * o;
      return A > so ? 1.f : (A == so ? 0.5f : 0.f);
    }
    return fmaf(c, o, a_own);
  }
};

// The ROP's per-feature part; the group sums it.
__device__ __forceinline__ float rop_part(int rop, float v) {
  return rop == NORM2 ? v * v : v;
}

// The SOP on the MUFU unit's approximations (exp2 and the reciprocal,
// within 2 ulp): the scalar chain is a share of an edge's instructions.
__device__ __forceinline__ float sop_apply(int sop, float t) {
  switch (sop) {
    case SIGMOID: return __fdividef(1.f, 1.f + __expf(-t));
    case TDIST: return __fdividef(1.f, 1.f + t);
    default: return t;
  }
}

// d SOP / dt, from t's image s = SOP(t).
__device__ __forceinline__ float sop_grad(int sop, float s) {
  switch (sop) {
    case SIGMOID: return s * (1.f - s);
    case TDIST: return -(s * s);
    default: return 1.f;
  }
}

// ---- the instantiated set -----------------------------------------------

template <int W_, int L_, int NV_, int ROP_, int SOP_>
struct Cfg {
  static constexpr int W = W_, L = L_, NV = NV_, ROP = ROP_, SOP = SOP_;
  // max/min VOPs only on the run-time instances
  static constexpr bool MM = ROP_ == RUNTIME;
};

// Calls f(Cfg<...>{}) with the lane layout for width k <= 256, k % 4 == 0
// (the wrappers pad a ragged K with zero features): float4s, two a lane
// above K = 16 (the scalar chain of an edge then serves 8 features a
// lane), L = K/8 lanes an edge in [4, 32].  The compiled set (ROP given)
// is 16 < K <= 256.
template <int ROP, int SOP, class F>
int with_layout(int k, F&& f) {
  if constexpr (ROP == RUNTIME) {
    if (k <= 16) return f(Cfg<4, 4, 1, ROP, SOP>{});
  }
  if (k <= 32) return f(Cfg<4, 4, 2, ROP, SOP>{});
  if (k <= 64) return f(Cfg<4, 8, 2, ROP, SOP>{});
  if (k <= 128) return f(Cfg<4, 16, 2, ROP, SOP>{});
  return f(Cfg<4, 32, 2, ROP, SOP>{});
}

// Calls f with the instance for width k and the pipeline: the compiled
// set for linear VOPs above K = 16, else the run-time codes.
template <class F>
int dispatch(int k, int vop, int rop, int sop, F&& f) {
  const bool compiled = vop != VMAX && vop != VMIN && k > 16;
  if (!compiled) return with_layout<RUNTIME, RUNTIME>(k, f);
#define FUSED_SOPS(R)                                             \
  switch (sop) {                                                  \
    case SOP_NONE: return with_layout<R, SOP_NONE>(k, f);         \
    case SIGMOID: return with_layout<R, SIGMOID>(k, f);           \
    default: return with_layout<R, TDIST>(k, f);                  \
  }
  switch (rop) {
    case NOOP: return with_layout<NOOP, RUNTIME>(k, f);  // SOP(1), once
    case DOT: FUSED_SOPS(DOT)
    default: FUSED_SOPS(NORM2)
  }
#undef FUSED_SOPS
}

}  // namespace fused
