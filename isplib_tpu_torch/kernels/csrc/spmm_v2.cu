// Sum-SpMM over a v2 cell plan (isplib_tpu_torch.kernels.spmm_v2).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_pallas_v2.py::
// _spmm_v2_kernel (entry spmm_tiled_v2).  Same function: for every real
// slot of the plan's chunks,
//     out[row, k] += val * x[col, k]
// with row = (s*nrb_s + rb_locals[chunk])*rb + plane 2, col = (cell %
// nct)*ct + plane 0 and s = cell / nct.  It is fp32 throughout: the TPU
// kernel rounds each product to bf16 before its one-hot scatter matmul, the
// port does not (the port holds every kernel to the fp32 reference).
//
// What bounds it on an H100: HBM bytes, namely the edge planes (12 B per
// slot, pads included, read once per K tile), one x tile per cell visited
// and the output; two operations per edge and feature are far below the
// fp32 peak.  The design (v2_cell.cuh) holds the cell's x tile in shared
// memory and streams the chunks past it.  A warp takes 32 slots at a time,
// read coalesced and broadcast with shuffles, lanes over features (NK per
// lane); pad slots (value 0) are skipped through a ballot.  A chunk's edges
// come in row order, so each lane keeps a running sum per feature while the
// row stays the same and adds it into the row block's fp32 accumulator in
// shared memory (rb x KT, by atomicAdd: the warps of a block share it) when
// the row changes.  A flush adds the accumulator's nonzero entries into the
// zeroed output with atomicAdd, since the column tiles of a superblock, and
// the runs of chunks of one cell, meet in the same rows.  The sums are
// therefore taken in an order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "v2_cell.cuh"

namespace {

using v2cell::FULL;
using v2cell::THREADS;

template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_v2_kernel(const int* __restrict__ edges,
                   const int* __restrict__ rb_locals,
                   const int* __restrict__ cell_starts,
                   const float* __restrict__ x, float* __restrict__ out,
                   int nc, int n_cells, int planes, int eb, int rb, int ct,
                   int nct, int nrb_s, int num_rows, int num_cols, int k) {
  constexpr int KT = 32 * NK;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;             // ct x KT
  float* acc = smem + ct * KT;   // rb x KT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.y * KT;
  for (int i = threadIdx.x; i < rb * KT; i += THREADS) acc[i] = 0.f;

  auto add_row = [&](int row, float (&sum)[NK]) {
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      atomicAdd(acc + row * KT + lane + 32 * t, sum[t]);
      sum[t] = 0.f;
    }
  };
  auto chunk = [&](int ch) {
    const int* e = edges + static_cast<size_t>(ch) * planes * eb;
    for (int g = warp * 32; g < eb; g += THREADS) {
      const int cl = e[g + lane];
      const float v = __int_as_float(e[eb + g + lane]);
      const int rl = e[2 * eb + g + lane];
      unsigned live = __ballot_sync(FULL, v != 0.f);
      if (!live) continue;
      int row = __shfl_sync(FULL, rl, __ffs(live) - 1);
      float sum[NK] = {};
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int rj = __shfl_sync(FULL, rl, j);
        const int cj = __shfl_sync(FULL, cl, j);
        const float vj = __shfl_sync(FULL, v, j);
        if (rj != row) {
          add_row(row, sum);
          row = rj;
        }
        const float* xr = x_s + cj * KT + lane;
#pragma unroll
        for (int t = 0; t < NK; ++t) sum[t] = fmaf(vj, xr[32 * t], sum[t]);
      }
      add_row(row, sum);
    }
  };
  auto flush = [&](int row0) {
    for (int i = threadIdx.x; i < rb * KT; i += THREADS) {
      const float s = acc[i];
      if (s == 0.f) continue;
      acc[i] = 0.f;
      const int r = row0 + i / KT, f = k0 + i % KT;
      if (r < num_rows && f < k)
        atomicAdd(out + static_cast<size_t>(r) * k + f, s);
    }
  };
  v2cell::walk<KT>(cell_starts, rb_locals, nc, n_cells, nct, nrb_s, rb, ct, x,
                   x_s, num_cols, k, k0, chunk, flush);
}

template <int NK>
size_t smem_bytes(int rb, int ct) {
  return static_cast<size_t>(ct + rb) * 32 * NK * sizeof(float);
}

template <int NK>
int launch(const void* edges, const void* rb_locals, const void* cell_starts,
           const void* x, void* out, int nc, int n_cells, int planes, int eb,
           int rb, int ct, int nct, int nrb_s, int num_rows, int num_cols,
           int k, cudaStream_t stream) {
  const size_t smem = smem_bytes<NK>(rb, ct);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_v2_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nc + v2cell::CHUNKS_PER_CTA - 1) / v2cell::CHUNKS_PER_CTA,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_v2_kernel<NK><<<grid, THREADS, smem, stream>>>(
      static_cast<const int*>(edges), static_cast<const int*>(rb_locals),
      static_cast<const int*>(cell_starts), static_cast<const float*>(x),
      static_cast<float*>(out), nc, n_cells, planes, eb, rb, ct, nct, nrb_s,
      num_rows, num_cols, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32, zeroed by the caller, += the plan's edges times x
// (num_cols, k) fp32, on CUDA device `device` and stream `stream`.  K tiles
// of 64 features (two a lane) where K > 32 and the tile and accumulator fit
// 100 KB of shared memory, so that two blocks share an SM; else 32.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int spmm_v2_launch(const void* edges, const void* rb_locals,
                              const void* cell_starts, const void* x,
                              void* out, int nc, int n_cells, int planes,
                              int eb, int rb, int ct, int nct, int nrb_s,
                              int num_rows, int num_cols, int k, int device,
                              void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 32 && smem_bytes<2>(rb, ct) <= 100 * 1024)
    return launch<2>(edges, rb_locals, cell_starts, x, out, nc, n_cells,
                     planes, eb, rb, ct, nct, nrb_s, num_rows, num_cols, k, s);
  return launch<1>(edges, rb_locals, cell_starts, x, out, nc, n_cells, planes,
                   eb, rb, ct, nct, nrb_s, num_rows, num_cols, k, s);
}
