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
// the segment list, and the a and b rows (K*4 B per distinct row; the b
// rows gathered per edge from L2 when they fit in its 50 MB, as at the main
// path's widths); two operations per edge and feature are far below the
// fp32 peak, so L2 bandwidth and the gathers' latency bound it in
// practice.  The design is K5's ROP = DOT on the lane layout of
// lane_layout.cuh: a warp per segment of at most SEG_EDGES edges of one
// row, a[r] loaded once per segment into every group's registers (every
// group holds the same row), an edge per group of L lanes (4 at K = 32: 8
// edges at once), each group's column word a round ahead, the gathers of
// 32 edges (at K = 32) in flight before their FMAs, the dot reduced by a
// log2(L)-step shuffle within the group, and each group's first lane
// storing its edge's dot, so a warp stores 32 / L consecutive edges at
// once.  One K tile holds K <= 640 (32 lanes, 20 floats a lane); a wider K
// walks tiles whose dots add with atomicAdd.  The row pitch and the
// operands' addresses set the vector width (float4, float2 or float: the
// wrapper pads an odd K with zero features to a multiple of 4, which add 0
// to the dot).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_layout.cuh"

namespace {

using namespace lanes;

// gathered floats in flight a lane: 32 ran 3.5% faster than 16 at K = 32
// and 41 on density-rep and as fast on the R-MAT graph; above K = 256
// twice as many (3 edges of 20 floats a lane in flight, not 1) ran 13% and
// 3% faster at K = 602 (probe_fused.py)
constexpr int GATHERED = 32;

struct Args {
  const int* seg_ptr;
  const int* seg_row;
  const int* col;
  const float* a;  // (num_rows, ld)
  const float* b;  // (num_cols, ld)
  float* out;      // (nnz_padded,)
  int nseg, k, ld;
};

// L lanes an edge, NV vectors of W floats a lane: K tiles of L*NV*W; GF
// gathered floats in flight a lane.
template <int W, int L, int NV, int GF>
__global__ void __launch_bounds__(THREADS)
    sddmm_kernel(const __grid_constant__ Args a) {
  constexpr int G = 32 / L, D = DEPTH<W, NV, GF>, KT = L * NV * W;
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= a.nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31, q = lane % L, grp = lane / L;
  const int k0 = blockIdx.y * KT, kt = a.k - k0;
  const int e0 = a.seg_ptr[item], e1 = a.seg_ptr[item + 1];
  const bool tiled = gridDim.y > 1;

  Row<W, L, NV> ar;
  ar.load(a.a + static_cast<size_t>(a.seg_row[item]) * a.ld + k0, q, kt);
  const float* bk = a.b + k0;
  // the last edge word a fetch reads: e1 - 1, or the list's first for an
  // empty segment (the graph's sentinel pad edge at least)
  const int last = max(e1 - 1, 0);
  EdgeWords<G, D> nxt;
  nxt.fetch(a.col, nullptr, false, e0, last, grp);
  for (int b = e0; b < e1; b += G * D) {
    const EdgeWords<G, D> cur = nxt;
    Row<W, L, NV> bv[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      bv[d].load(bk + static_cast<size_t>(cur.c[d]) * a.ld, q, kt);
    if (b + G * D < e1) nxt.fetch(a.col, nullptr, false, b + G * D, last, grp);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int w = 0; w < W; ++w)
          part = fmaf(ar.v[t].f[w], bv[d].v[t].f[w], part);
      const float dot = group_sum<L>(part);
      const int e = b + d * G + grp;
      if (q == 0 && e < e1) {
        if (tiled)
          atomicAdd(a.out + e, dot);
        else
          a.out[e] = dot;
      }
    }
  }
}

// F floats a lane: NV = F / W vectors
template <int W, int L, int F, int GF = GATHERED>
int launch(const Args& a, cudaStream_t s) {
  constexpr int NV = F / W, KT = L * F;
  const dim3 grid((a.nseg + THREADS / 32 - 1) / (THREADS / 32),
                  (a.k + KT - 1) / KT);
  sddmm_kernel<W, L, NV, GF><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The fewest lanes (at least 4) whose 8 floats a lane cover K (4 at K <=
// 16), else 32 lanes of 20 floats in K tiles of 640.
template <int W>
int launch_width(const Args& a, cudaStream_t s) {
  if (a.k <= 16) return launch<W, 4, 4>(a, s);
  if (a.k <= 32) return launch<W, 4, 8>(a, s);
  if (a.k <= 64) return launch<W, 8, 8>(a, s);
  if (a.k <= 128) return launch<W, 16, 8>(a, s);
  if (a.k <= 256) return launch<W, 32, 8>(a, s);
  return launch<W, 32, 20, 2 * GATHERED>(a, s);
}

}  // namespace

// out[e] = <a[row e], b[col e]> for the CSR edges cut by the plan's
// segments; a (num_rows, k) and b (num_cols, k) fp32 with row pitch ld >= k
// (features k to the vector width's next multiple are zeros), out zeroed
// by the caller, on CUDA device `device` and stream `stream`.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int sddmm_launch(const void* seg_ptr, const void* seg_row,
                            const void* col, const void* a, const void* b,
                            void* out, int nseg, int k, int ld, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ld < k) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg == 0 || k == 0) return 0;
  const Args args{static_cast<const int*>(seg_ptr),
                  static_cast<const int*>(seg_row),
                  static_cast<const int*>(col),
                  static_cast<const float*>(a),
                  static_cast<const float*>(b),
                  static_cast<float*>(out),
                  nseg, k, ld};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = vec_width(ld, {a, b});
  if (w == 4) return launch_width<4>(args, s);
  if (w == 2) return launch_width<2>(args, s);
  return launch_width<1>(args, s);
}
