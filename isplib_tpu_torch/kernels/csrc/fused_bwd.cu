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
//     a  = <g[i], v>                       (a shuffle reduction)
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
// What bounds it on an H100: HBM bytes are each list's col and val (8 B per
// edge), the segment lists, the rows read once and the outputs; the
// gathered rows come from L2 when they fit in its 50 MB: a y row per edge
// in pass A, an x and a g row per edge in pass B (2.2 GB over both passes
// at K = 32 on the R-MAT graph of 5.7M edges), so L2 bandwidth and the
// gathers' latency bound it in practice.  The design is K5's (fused.cu and
// fused_ops.cuh): a warp per segment of one row, an edge per group of L
// lanes, the segment row's operands in registers with the VOP decoded
// against them once, the two reductions (t and a) as interleaved
// log2(L)-step shuffles, the scalar chain once per group, the column and
// value words a round ahead, the gathers of 16 edges (pass A) or 8 (pass
// B, two rows an edge) at K = 32 in flight before their arithmetic, ROP and
// SOP compiled in, and one store per row of one segment, atomicAdd into the
// pre-zeroed split rows.  Pass B recomputes t, s, a and ŝ, which pass A
// had: caching them per edge (8 B, read in CSC order through csc2csr)
// made the two passes 10% (sigmoid embedding) and 15% (t-distribution)
// slower at K = 32 (probe_fused.py).  A ragged K arrives padded with zero
// features (the wrapper), which add 0 to both reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_ops.cuh"

namespace {

using namespace fused;

struct Args {
  const int* seg_ptr;
  const int* seg_row;
  const int* seg_slot;
  const int* col;
  const float* val;
  const float* x;
  const float* y;
  const float* g;
  float* out;
  int nseg, k, vop, rop, sop, vsc;
};

// PASS_B = false: the segments are rows i of A, col[e] = j, and the kernel
// emits grad_x.  PASS_B = true: the segments are rows j of Aᵀ (the CSC),
// col[e] = i, and it emits grad_y.
template <class C, bool PASS_B>
__global__ void __launch_bounds__(THREADS) fused_bwd_kernel(const Args a) {
  constexpr int W = C::W, L = C::L, NV = C::NV, G = 32 / L;
  constexpr int D = DEPTH<W, PASS_B ? 2 * NV : NV>;  // x and g in pass B
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= a.nseg) return;  // uniform across the warp
  const int rop = C::ROP == RUNTIME ? a.rop : C::ROP;
  const int sop = C::SOP == RUNTIME ? a.sop : C::SOP;
  const int lane = threadIdx.x & 31, q = lane % L, grp = lane / L;
  const int e0 = a.seg_ptr[item], e1 = a.seg_ptr[item + 1];
  const int r = a.seg_row[item], k = a.k;
  const VopSide vs(a.vop, PASS_B);
  const bool use_w = a.vsc != VSC_NONE;
  const size_t own = static_cast<size_t>(r) * k;

  // the VOP's coefficients against the own row (x[i] in pass A, y[j] in
  // pass B), g[i] (pass A), the sum
  Row<W, L, NV> cA, cB, g_own, acc;
  cA.load((PASS_B ? a.y : a.x) + own, q, k);
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int w = 0; w < W; ++w) vs.coef(cA.v[t].f[w], cA.v[t].f[w],
                                        cB.v[t].f[w]);
  if (!PASS_B) g_own.load(a.g + own, q, k);
  acc.zero();
  const float s_one = sop_apply(sop, 1.f);  // the SOP of ROP = NOOP's t

  // the last edge word a fetch reads: e1 - 1, or the arrays' first for an
  // empty segment (they hold at least the graph's sentinel pad edge)
  const int last = max(e1 - 1, 0);
  EdgeWords<G, D> nxt;
  nxt.fetch(a.col, a.val, use_w, e0, last, grp);
  for (int b = e0; b < e1; b += G * D) {
    const EdgeWords<G, D> cur = nxt;
    // the gathered rows: y[j] (pass A), or x[i] and g[i] (pass B)
    Row<W, L, NV> ov[D], gv[PASS_B ? D : 1];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t oc = static_cast<size_t>(cur.c[d]) * k;
      if (vs.need_other)
        ov[d].load((PASS_B ? a.x : a.y) + oc, q, k);
      else
        ov[d].zero();
      if constexpr (PASS_B) gv[d].load(a.g + oc, q, k);
    }
    if (b + G * D < e1) nxt.fetch(a.col, a.val, use_w, b + G * D, last, grp);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const Row<W, L, NV>& gi = PASS_B ? gv[PASS_B ? d : 0] : g_own;
      Row<W, L, NV> v;
      float pt = 0.f, pa = 0.f;
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          v.v[t].f[w] = vs.apply<C::MM>(cA.v[t].f[w], cB.v[t].f[w],
                                        ov[d].v[t].f[w]);
          if (rop != NOOP) {
            pt += rop_part(rop, v.v[t].f[w]);
            pa = fmaf(gi.v[t].f[w], v.v[t].f[w], pa);
          }
        }
      // the edge's scalars: sw = SOP(t) * w and shat = a * w * SOP'(t)
      float sw = s_one * cur.w[d], shat = 0.f;
      if (rop != NOOP) {
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) {
          pt += __shfl_xor_sync(FULL, pt, o);
          pa += __shfl_xor_sync(FULL, pa, o);
        }
        const float s = sop_apply(sop, pt);
        sw = s * cur.w[d];
        shat = pa * cur.w[d] * sop_grad(sop, s);
      }
      if (b + d * G + grp < e1) {
#pragma unroll
        for (int t = 0; t < NV; ++t)
#pragma unroll
          for (int w = 0; w < W; ++w) {
            float dd = sw * gi.v[t].f[w];
            if (rop == DOT) dd += shat;
            if (rop == NORM2) dd = fmaf(2.f * shat, v.v[t].f[w], dd);
            acc.v[t].f[w] = fmaf(
                vs.d_own<C::MM>(cA.v[t].f[w], ov[d].v[t].f[w]), dd,
                acc.v[t].f[w]);
          }
      }
    }
  }

  store_row(acc, a.out + own, lane, k, a.seg_slot[item] < 0, 1.f);
}

}  // namespace

// One backward pass of the sum-accumulated pipeline (codes of
// fused_ops.cuh).  Pass A (pass_b = 0): the plan and (col, val) are the
// CSR's, out is grad_x (num_rows, k).  Pass B (pass_b = 1): the plan and
// (col, val) are the CSC's, out is grad_y (num_cols, k).  (col, val) are at
// least one edge long; x (num_rows, k), y (num_cols, k) and g (num_rows,
// k) fp32, k <= 256 and k % 4 == 0, on CUDA device `device` and stream
// `stream`.  out need not be zeroed: the nsplit rows split_rows are zeroed
// first, one more launch.  Returns the CUDA error of the launches (0 =
// launched).
extern "C" int fused_bwd_launch(const void* seg_ptr, const void* seg_row,
                                const void* seg_slot, const void* split_rows,
                                const void* col, const void* val,
                                const void* x, const void* y, const void* g,
                                void* out, int nseg, int nsplit, int k,
                                int vop, int rop, int sop, int vsc,
                                int pass_b, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k % 4 != 0 || k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const int e = zero_rows(split_rows, out, nsplit, k, s)) return e;
  if (nseg == 0) return 0;
  const Args a{static_cast<const int*>(seg_ptr),
               static_cast<const int*>(seg_row),
               static_cast<const int*>(seg_slot),
               static_cast<const int*>(col),
               static_cast<const float*>(val),
               static_cast<const float*>(x),
               static_cast<const float*>(y),
               static_cast<const float*>(g),
               static_cast<float*>(out),
               nseg, k, vop, rop, sop, vsc};
  const int blocks = (nseg + THREADS / 32 - 1) / (THREADS / 32);
  return dispatch(k, vop, rop, sop, [&](auto cfg) {
    if (pass_b)
      fused_bwd_kernel<decltype(cfg), true><<<blocks, THREADS, 0, s>>>(a);
    else
      fused_bwd_kernel<decltype(cfg), false><<<blocks, THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}
