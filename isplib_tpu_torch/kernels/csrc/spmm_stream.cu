// Sum-SpMM over the residual edges of a hybrid plan, added into the output
// of the dense half (the residual half of isplib_tpu_torch.kernels.spmm_hybrid).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_pallas_v4.py::_v4_kernel
// (entry spmm_stream_v4).  Same function: for every residual edge e of row r,
//     out[r, k] += val[e] * x[col[e], k]
// here in fp32 throughout (operands and accumulation).
//
// What bounds it on an H100: HBM bytes, namely col + val (8 B per edge), the
// segment list and row pointers, and the gathered x rows (K*4 B per edge,
// served from L2 when x fits in its 50 MB, as at the main path's widths); two
// operations per edge and feature are far below any compute peak, so L2
// bandwidth and the gathers' latency bound it in practice.  The design is
// the lane layout of lane_layout.cuh (K5's): a warp per segment of at most
// SEG_EDGES edges of one row (the plan cuts rows into segments, so an R-MAT
// hub row spreads over many warps), an edge per group of L lanes with
// float4 rows (4 lanes at K = 32: 8 edges at once), each group's column
// and value words a round ahead, the gathers of 8 edges (at K = 32) in
// flight before their FMAs, and the groups' sums meeting by shuffles once
// per segment.  A row that is one segment is read, added to and stored by
// its warp alone; the segments of a split row add with atomicAdd.  Above
// K = 128 the grid walks K tiles of 128 features (32 lanes an edge) as its
// slow index, so one tile's slice of x is what L2 holds at a time.  x's row
// pitch and address set the vector width (float4, float2 or float: the
// wrapper pads an odd K to a multiple of 4); out keeps its pitch K and is
// stored feature by feature where its rows do not take the vectors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_layout.cuh"

namespace {

using namespace lanes;

// gathered floats in flight a lane: 8 ran 7%, 11% and 1% faster than 16 at
// K = 32, 41 and 602 on density-rep's residual edges (probe_fused.py), whose
// segments of ~50 edges leave less of a round of 8 edges masked
constexpr int GATHERED = 8;

struct Args {
  const int* rowptr;
  const int* col;
  const float* val;
  const int* seg_ptr;
  const int* seg_row;
  const float* x;  // (num_cols, ldx)
  float* out;      // (num_rows, k)
  int nseg, k, ldx, vec_out;
};

// L lanes an edge, NV vectors of W floats a lane: K tiles of L*NV*W.
template <int W, int L, int NV>
__global__ void __launch_bounds__(THREADS)
    spmm_stream_kernel(const __grid_constant__ Args a) {
  constexpr int G = 32 / L, D = DEPTH<W, NV, GATHERED>, KT = L * NV * W;
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (item >= a.nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31, q = lane % L, grp = lane / L;
  const int k0 = blockIdx.y * KT, kt = a.k - k0;
  const int e0 = a.seg_ptr[item], e1 = a.seg_ptr[item + 1];
  const int r = a.seg_row[item];
  const float* x = a.x + k0;

  Row<W, L, NV> acc;
  acc.zero();
  const int last = max(e1 - 1, 0);
  EdgeWords<G, D> nxt;
  nxt.fetch(a.col, a.val, true, e0, last, grp);
  for (int b = e0; b < e1; b += G * D) {
    const EdgeWords<G, D> cur = nxt;
    Row<W, L, NV> xv[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      xv[d].load(x + static_cast<size_t>(cur.c[d]) * a.ldx, q, kt);
    if (b + G * D < e1) nxt.fetch(a.col, a.val, true, b + G * D, last, grp);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (b + d * G + grp < e1) {
#pragma unroll
        for (int t = 0; t < NV; ++t)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc.v[t].f[w] = fmaf(cur.w[d], xv[d].v[t].f[w], acc.v[t].f[w]);
      }
    }
  }

  const bool whole = e0 == a.rowptr[r] && e1 == a.rowptr[r + 1];
  store_row<true>(acc, a.out + static_cast<size_t>(r) * a.k + k0, lane, kt,
                  whole, 1.f, a.vec_out != 0);
}

// F floats a lane: NV = F / W vectors
template <int W, int L, int F>
int launch(const Args& a, cudaStream_t s) {
  constexpr int NV = F / W, KT = L * F;
  const dim3 grid((a.nseg + THREADS / 32 - 1) / (THREADS / 32),
                  (a.k + KT - 1) / KT);
  spmm_stream_kernel<W, L, NV><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The fewest lanes (at least 4) whose 8 floats a lane cover K (4 at K <=
// 16), else 32 lanes of 4 floats in K tiles of 128.
template <int W>
int launch_width(const Args& a, cudaStream_t s) {
  if (a.k <= 16) return launch<W, 4, 4>(a, s);
  if (a.k <= 32) return launch<W, 4, 8>(a, s);
  if (a.k <= 64) return launch<W, 8, 8>(a, s);
  if (a.k <= 128) return launch<W, 16, 8>(a, s);
  return launch<W, 32, 4>(a, s);
}

}  // namespace

// out (num_rows, k) fp32 += residual half of the plan times x (num_cols, k)
// fp32 with row pitch ldx >= k, on CUDA device `device` and stream
// `stream`.  Returns the CUDA error of the launch (0 = launched).
extern "C" int spmm_stream_launch(const void* rowptr, const void* col,
                                  const void* val, const void* seg_ptr,
                                  const void* seg_row, const void* x,
                                  void* out, int nseg, int k, int ldx,
                                  int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ldx < k) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg == 0 || k == 0) return 0;
  const int w = vec_width(ldx, {x});
  const Args a{static_cast<const int*>(rowptr),
               static_cast<const int*>(col),
               static_cast<const float*>(val),
               static_cast<const int*>(seg_ptr),
               static_cast<const int*>(seg_row),
               static_cast<const float*>(x),
               static_cast<float*>(out),
               nseg, k, ldx, vec_width(k, {out}) >= w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 4) return launch_width<4>(a, s);
  if (w == 2) return launch_width<2>(a, s);
  return launch_width<1>(a, s);
}
