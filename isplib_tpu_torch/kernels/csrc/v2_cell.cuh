// The walk over a v2 plan's chunks of the cell-streaming max/min kernel
// (spmm_minmax.cu, K7).  The sum kernel over the same plans (spmm_v2.cu,
// K8) walked it too until it took K10's row walk (row_walk.cuh).
//
// A v2 plan (isplib_tpu_torch/sparse/tiling_v2.py) lists edge chunks cell by
// cell, a cell being one (row superblock, column tile) pair; the chunks of a
// cell read x only in the cell's tile of ct rows.  Each block takes
// CHUNKS_PER_CTA consecutive chunks and one tile of KT features.  It loads
// the x tile of the cell it is in into shared memory once, with cp.async,
// and reloads it only where its run of chunks crosses into the next cell:
// the tile reuse the v2 layout is built for.  Runs of equal length rather
// than one block per cell keep the SMs busy where a graph has few cells
// with many chunks each (a shard of 2,912 rows has 23 cells per K tile).
// The caller accumulates a chunk's row block in shared memory; the walk
// calls `flush(row0)` whenever the row block or the cell changes, and at
// the end, with the block synchronised before and after.  Blocks run in no
// order and several meet in one output row, so a flush combines into the
// output with atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace v2cell {

constexpr int THREADS = 256;  // 8 warps
constexpr int CHUNKS_PER_CTA = 8;
constexpr unsigned FULL = 0xffffffffu;

// 4-byte copy; src_bytes = 0 zero-fills the destination without reading
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

// The cell that holds chunk ch: the last cell whose first chunk is <= ch
// (an empty cell shares its first chunk with the next one).
__device__ __forceinline__ int cell_of(const int* __restrict__ cell_starts,
                                       int n_cells, int ch) {
  int lo = 0, hi = n_cells;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cell_starts[mid] <= ch)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// x_s[c * KT + n] = x[c0 + c, k0 + n] for c < ct, zero outside x.
template <int KT>
__device__ __forceinline__ void load_x_tile(float* x_s,
                                            const float* __restrict__ x,
                                            int c0, int ct, int num_cols,
                                            int k, int k0) {
  for (int q = threadIdx.x; q < ct * KT; q += THREADS) {
    const int c = q / KT, n = q % KT;
    const bool ok = c0 + c < num_cols && k0 + n < k;
    cp_async4(x_s + q, ok ? x + static_cast<size_t>(c0 + c) * k + k0 + n : x,
              ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Walk this block's run of chunks: chunk(ch) accumulates chunk ch (whose
// columns the x tile x_s holds), flush(row0) moves the accumulated row
// block starting at output row row0 out and zeroes it.
template <int KT, class Chunk, class Flush>
__device__ __forceinline__ void walk(const int* __restrict__ cell_starts,
                                     const int* __restrict__ rb_locals,
                                     int nc, int n_cells, int nct, int nrb_s,
                                     int rb, int ct,
                                     const float* __restrict__ x, float* x_s,
                                     int num_cols, int k, int k0,
                                     Chunk chunk, Flush flush) {
  const int ch0 = blockIdx.x * CHUNKS_PER_CTA;
  const int ch1 = min(ch0 + CHUNKS_PER_CTA, nc);
  int cell = 0, cell_end = -1, row0 = -1;
  for (int ch = ch0; ch < ch1; ++ch) {  // every test below is block-uniform
    const bool new_cell = ch >= cell_end;
    if (new_cell) {
      cell = cell_of(cell_starts, n_cells, ch);
      cell_end = cell_starts[cell + 1];
    }
    const int r0 = ((cell / nct) * nrb_s + rb_locals[ch]) * rb;
    if (new_cell || r0 != row0) {
      if (row0 >= 0) {
        __syncthreads();
        flush(row0);
      }
      if (new_cell)
        load_x_tile<KT>(x_s, x, (cell % nct) * ct, ct, num_cols, k, k0);
      else
        __syncthreads();
      row0 = r0;
    }
    chunk(ch);
  }
  __syncthreads();
  if (row0 >= 0) flush(row0);
}

}  // namespace v2cell
