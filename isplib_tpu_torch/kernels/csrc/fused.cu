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
// fp32 and MEAN scales the row's sum by one reciprocal of its degree.
// Under VSC_NONE a real edge of value 0 counts, as on the XLA path (the TPU
// kernel drops it); pad edges lie past the last segment and are never read.
//
// What bounds it on an H100: HBM bytes are col and val (8 B per edge), the
// segment list, the x rows and out; the gathered y rows (K*4 B per edge,
// 733 MB at K = 32 on the R-MAT graph of 5.7M edges) come from L2 (y is
// 1.5 MB there), so L2 bandwidth and the gathers' latency bound it in
// practice.  A few operations per edge and feature are far below the fp32
// peak, but they are issued per edge: a design that gives each edge a
// whole warp, one feature a lane, spends a warp instruction per edge on
// every scalar step (shuffles, the reduction, the SOP).  This design
// (fused_ops.cuh): a warp per segment of <= SEG_EDGES edges of one row, an
// edge per group of L lanes (4 at K = 32, two float4 a lane, so 8 edges at
// once), the ROP as a log2(L)-step shuffle, the SOP (on MUFU) and VSC once
// per group, the column and value words a round ahead, the gathers of 16
// edges (at K = 32) in flight before their arithmetic, the VOP decoded
// once per segment into one FMA a feature, and ROP and SOP compiled in.
// A row that is one segment is stored; the segments of a split row add
// with atomicAdd into the row that a pre-pass zeroed (only the split rows:
// an empty row has its own empty segment).

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
  const float* deg;
  const float* x;
  const float* y;
  float* out;
  int nseg, k, vop, rop, sop, vsc;
};

template <class C>
__global__ void __launch_bounds__(THREADS) fused_kernel(const Args a) {
  constexpr int W = C::W, L = C::L, NV = C::NV, G = 32 / L;
  constexpr int D = DEPTH<W, NV>;
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= a.nseg) return;  // uniform across the warp
  const int rop = C::ROP == RUNTIME ? a.rop : C::ROP;
  const int sop = C::SOP == RUNTIME ? a.sop : C::SOP;
  const int lane = threadIdx.x & 31, q = lane % L, grp = lane / L;
  const int e0 = a.seg_ptr[item], e1 = a.seg_ptr[item + 1];
  const int r = a.seg_row[item], k = a.k;
  const VopSide vs(a.vop, false);
  const bool use_w = a.vsc != VSC_NONE;

  Row<W, L, NV> cA, cB, acc;  // VOP coefficients against x[r]; the sum
  cA.load(a.x + static_cast<size_t>(r) * k, q, k);
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int w = 0; w < W; ++w) vs.coef(cA.v[t].f[w], cA.v[t].f[w],
                                        cB.v[t].f[w]);
  acc.zero();
  const float s_one = sop_apply(sop, 1.f);  // the SOP of ROP = NOOP's t

  // the last edge word a fetch reads: e1 - 1, or the arrays' first for an
  // empty segment (they hold at least the graph's sentinel pad edge)
  const int last = max(e1 - 1, 0);
  EdgeWords<G, D> nxt;
  nxt.fetch(a.col, a.val, use_w, e0, last, grp);
  for (int b = e0; b < e1; b += G * D) {
    const EdgeWords<G, D> cur = nxt;
    Row<W, L, NV> yv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (vs.need_other)
        yv[d].load(a.y + static_cast<size_t>(cur.c[d]) * k, q, k);
      else
        yv[d].zero();
    }
    if (b + G * D < e1) nxt.fetch(a.col, a.val, use_w, b + G * D, last, grp);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float& v = yv[d].v[t].f[w];
          v = vs.apply<C::MM>(cA.v[t].f[w], cB.v[t].f[w], v);
          if (rop != NOOP) part += rop_part(rop, v);
        }
      const float s = cur.w[d] *
          (rop == NOOP ? s_one : sop_apply(sop, group_sum<L>(part)));
      if (b + d * G + grp < e1) {
#pragma unroll
        for (int t = 0; t < NV; ++t)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc.v[t].f[w] = fmaf(s, yv[d].v[t].f[w], acc.v[t].f[w]);
      }
    }
  }

  const float scale =
      a.vsc == VSC_MEAN ? 1.f / fmaxf(__ldg(a.deg + r), 1.f) : 1.f;
  store_row(acc, a.out + static_cast<size_t>(r) * k, lane, k,
            a.seg_slot[item] < 0, scale);
}

}  // namespace

// out (num_rows, k) fp32 = the sum-accumulated pipeline (vop, rop, sop,
// vsc: the codes of fused_ops.cuh) over the CSR edges (col, val; at least
// one edge long) cut by the plan's segments, with x (num_rows, k), y (num_cols, k) and deg
// (num_rows,) fp32, k <= 256 and k % 4 == 0, on CUDA device `device` and
// stream `stream`.  out need not be zeroed: the nsplit rows split_rows are
// zeroed first, one more launch.  Returns the CUDA error of the launches
// (0 = launched).
extern "C" int fused_launch(const void* seg_ptr, const void* seg_row,
                            const void* seg_slot, const void* split_rows,
                            const void* col, const void* val,
                            const void* deg, const void* x, const void* y,
                            void* out, int nseg, int nsplit, int k, int vop,
                            int rop, int sop, int vsc, int device,
                            void* stream) {
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
               static_cast<const float*>(deg),
               static_cast<const float*>(x),
               static_cast<const float*>(y),
               static_cast<float*>(out),
               nseg, k, vop, rop, sop, vsc};
  const int blocks = (nseg + THREADS / 32 - 1) / (THREADS / 32);
  return dispatch(k, vop, rop, sop, [&](auto cfg) {
    fused_kernel<decltype(cfg)><<<blocks, THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}
