// Max/min SpMM with the winning edge id per (row, feature) over a with-eids
// v2 cell plan (isplib_tpu_torch.kernels.spmm_minmax).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_minmax.py::_minmax_kernel
// (entry spmm_minmax_tiled).  Same function: for every row r and feature k,
//     out[r, k] = max over the plan's edges e of row r of val[e] * x[col, k]
//     arg[r, k] = the lowest edge id (plane 3) that attains it
// and for min the same on the negated products; pad slots (id -1) take no
// part.  It is exact fp32 (one multiply and one compare per edge and
// feature).  Empty rows give out = 0 and arg = sentinel.  out is decoded
// from the winner's key, so it is the winner's product with a zero made
// +0.0 before the sign of min is put back, as the TPU kernel's exact
// one-hot moves give it; the plain version computes the same bits.
//
// What bounds it on an H100: HBM bytes, namely the four edge planes (16 B
// per slot, read once per K tile), one x tile per cell visited, the zeroed
// 64-bit scratch (written by atomics, read by the decode) and out + arg.
// The design is the cell walk (v2_cell.cuh, K8's until K8 took K10's row
// walk): the cell's x tile in shared memory, a warp per 32 slots, lanes over
// features, pad slots skipped by a ballot.  The TPU kernel's segmented scan
// and one-hot moves become keys: each lane keeps, per feature, the largest key
// (minmax_key.cuh: ordered value, then the lower id) of the current row in
// registers and, when the row changes, combines it into the row block's key
// array in shared memory (rb x KT, 64-bit atomicMax); a flush combines the
// nonzero keys into the global scratch (R, K) with atomicMax, and a second
// kernel decodes every key into out and arg.  A maximum of keys does not
// depend on the order in which they meet, so the result is the same in every
// run.  This is K3's scheme (spmm_minmax_v4.cu) on the cell walk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minmax_key.cuh"
#include "v2_cell.cuh"

namespace {

using v2cell::FULL;
using v2cell::THREADS;
using u64 = unsigned long long;

template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_minmax_v2_kernel(const int* __restrict__ edges,
                          const int* __restrict__ rb_locals,
                          const int* __restrict__ cell_starts,
                          const float* __restrict__ x,
                          u64* __restrict__ keys_g,
                          int nc, int n_cells, int eb, int rb, int ct,
                          int nct, int nrb_s, int num_rows, int num_cols,
                          int k, float sgn) {
  constexpr int KT = 32 * NK;
  constexpr int PLANES = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);                  // ct x KT
  u64* keys = reinterpret_cast<u64*>(smem + ct * KT * sizeof(float));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.y * KT;
  for (int i = threadIdx.x; i < rb * KT; i += THREADS) keys[i] = 0ull;

  auto max_row = [&](int row, u64 (&best)[NK]) {
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      atomicMax(keys + row * KT + lane + 32 * t, best[t]);
      best[t] = 0ull;
    }
  };
  auto chunk = [&](int ch) {
    const int* e = edges + static_cast<size_t>(ch) * PLANES * eb;
    for (int g = warp * 32; g < eb; g += THREADS) {
      const int cl = e[g + lane];
      const float v = __int_as_float(e[eb + g + lane]);
      const int rl = e[2 * eb + g + lane];
      const int id = e[3 * eb + g + lane];
      unsigned live = __ballot_sync(FULL, id >= 0);
      if (!live) continue;
      int row = __shfl_sync(FULL, rl, __ffs(live) - 1);
      u64 best[NK] = {};
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int rj = __shfl_sync(FULL, rl, j);
        const int cj = __shfl_sync(FULL, cl, j);
        const float vj = __shfl_sync(FULL, v, j);
        const int ij = __shfl_sync(FULL, id, j);
        if (rj != row) {
          max_row(row, best);
          row = rj;
        }
        const float* xr = x_s + cj * KT + lane;
#pragma unroll
        for (int t = 0; t < NK; ++t) {
          // sgn * p is exact, so sgn * value(key) is the winner's product
          const u64 key = minmax_key(sgn * __fmul_rn(vj, xr[32 * t]), ij);
          best[t] = key > best[t] ? key : best[t];
        }
      }
      max_row(row, best);
    }
  };
  auto flush = [&](int row0) {
    for (int i = threadIdx.x; i < rb * KT; i += THREADS) {
      const u64 key = keys[i];
      if (key == 0ull) continue;
      keys[i] = 0ull;
      const int r = row0 + i / KT, f = k0 + i % KT;
      if (r < num_rows && f < k)
        atomicMax(keys_g + static_cast<size_t>(r) * k + f, key);
    }
  };
  v2cell::walk<KT>(cell_starts, rb_locals, nc, n_cells, nct, nrb_s, rb, ct, x,
                   x_s, num_cols, k, k0, chunk, flush);
}

__global__ void __launch_bounds__(THREADS)
    decode_keys(const u64* __restrict__ keys_g, float* __restrict__ out,
                int* __restrict__ arg, size_t n, float sgn, int sentinel) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const u64 key = keys_g[i];
  out[i] = key ? sgn * minmax_key_value(key) : 0.f;
  arg[i] = key ? minmax_key_id(key) : sentinel;
}

template <int NK>
size_t smem_bytes(int rb, int ct) {
  return static_cast<size_t>(ct) * 32 * NK * sizeof(float) +
         static_cast<size_t>(rb) * 32 * NK * sizeof(u64);
}

template <int NK>
int launch(const void* edges, const void* rb_locals, const void* cell_starts,
           const void* x, void* out, void* arg, void* scratch, int nc,
           int n_cells, int eb, int rb, int ct, int nct, int nrb_s,
           int num_rows, int num_cols, int k, float sgn, int sentinel,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<NK>(rb, ct);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_minmax_v2_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nc + v2cell::CHUNKS_PER_CTA - 1) / v2cell::CHUNKS_PER_CTA,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_minmax_v2_kernel<NK><<<grid, THREADS, smem, stream>>>(
      static_cast<const int*>(edges), static_cast<const int*>(rb_locals),
      static_cast<const int*>(cell_starts), static_cast<const float*>(x),
      static_cast<u64*>(scratch), nc, n_cells, eb, rb, ct, nct, nrb_s,
      num_rows, num_cols, k, sgn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(num_rows) * k;
  decode_keys<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS,
                0, stream>>>(static_cast<const u64*>(scratch),
                             static_cast<float*>(out), static_cast<int*>(arg),
                             n, sgn, sentinel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32 and arg (num_rows, k) int32 = max (negate = 0) or
// min (negate = 1) SpMM of the with-eids plan times x (num_cols, k) fp32, on
// CUDA device `device` and stream `stream`.  `scratch` is (num_rows, k)
// uint64, zeroed by the caller.  K tiles of 64 features where K > 32 and
// the x tile and the keys fit 100 KB of shared memory (two blocks an SM),
// else 32.  Returns the CUDA error of the launches (0 = launched).
extern "C" int spmm_minmax_v2_launch(const void* edges, const void* rb_locals,
                                     const void* cell_starts, const void* x,
                                     void* out, void* arg, void* scratch,
                                     int nc, int n_cells, int eb, int rb,
                                     int ct, int nct, int nrb_s, int num_rows,
                                     int num_cols, int k, int negate,
                                     int sentinel, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sgn = negate ? -1.f : 1.f;
  if (k > 32 && smem_bytes<2>(rb, ct) <= 100 * 1024)
    return launch<2>(edges, rb_locals, cell_starts, x, out, arg, scratch, nc,
                     n_cells, eb, rb, ct, nct, nrb_s, num_rows, num_cols, k,
                     sgn, sentinel, s);
  return launch<1>(edges, rb_locals, cell_starts, x, out, arg, scratch, nc,
                   n_cells, eb, rb, ct, nct, nrb_s, num_rows, num_cols, k, sgn,
                   sentinel, s);
}
