// Sum-SpMM over a v1 row-block plan (isplib_tpu_torch.kernels.spmm_rowblock).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_pallas.py::
// _spmm_rowblock_kernel (entry spmm_tiled).  Same function: for every real
// slot of the plan's chunks,
//     out[rb_ids[c]*rb + plane 0, k] += plane 2 * x[ct_ids[c]*ct + plane 1, k]
// in fp32 throughout.  The TPU kernel builds one-hot gather and scatter
// matrices per chunk and multiplies them on its matrix unit (in bf16 on the
// chip); none of that is carried over.
//
// What bounds it on an H100: HBM bytes, namely the edge planes (12 B a
// slot, read once per K tile), the gathered x rows and the output; two
// operations per edge and feature are far below the fp32 peak.  The design:
// a CTA takes a run of CHUNKS_PER_CTA consecutive chunks (chunks come row
// block by row block) and one tile of KT = 32*NK features, and keeps the
// row block's (rb x KT) fp32 accumulator in shared memory.  The warps share
// out the run's 32-slot groups; a warp reads its group's planes coalesced,
// skips pad slots (value 0) through a ballot, broadcasts each slot with
// shuffles and, lanes over features, gathers the x row from global memory
// into a running sum per feature, which it adds into the accumulator
// (shared-memory atomics) when the row changes: a chunk's slots come in row
// order.  Where the run leaves a row block the accumulator is written out: a
// row block that lies wholly in the run is stored, each output row once; one
// that spans several runs is added with atomicAdd into the zeroed output, so
// its sums are taken in an order that changes from run to run.  Runs rather
// than one CTA per row block keep the SMs busy on skewed graphs (reddit-sim
// at rb = 256 has 46 row blocks for 132 SMs, R-MAT hubs in the first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNKS_PER_CTA = 32;
constexpr unsigned FULL = 0xffffffffu;

template <int NK>
__global__ void __launch_bounds__(THREADS)
    spmm_rowblock_kernel(const int* __restrict__ edges,
                         const int* __restrict__ rb_ids,
                         const int* __restrict__ ct_ids,
                         const int* __restrict__ chunk_starts,
                         const float* __restrict__ x, float* __restrict__ out,
                         int nc, int eb, int rb, int ct, int num_rows, int k) {
  constexpr int KT = 32 * NK;
  extern __shared__ __align__(16) float acc[];  // rb x KT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.y * KT;
  const int ch0 = blockIdx.x * CHUNKS_PER_CTA;
  const int ch1 = min(ch0 + CHUNKS_PER_CTA, nc);
  bool live_f[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) live_f[t] = k0 + lane + 32 * t < k;
  for (int i = threadIdx.x; i < rb * KT; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  auto add_row = [&](int row, float (&sum)[NK]) {
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      atomicAdd(acc + row * KT + lane + 32 * t, sum[t]);
      sum[t] = 0.f;
    }
  };
  const int groups_per_chunk = eb / 32;
  for (int ch = ch0; ch < ch1;) {  // every test below is block-uniform
    const int r = rb_ids[ch];
    const int rb_first = chunk_starts[r], rb_end = chunk_starts[r + 1];
    const int seg_end = min(ch1, rb_end);
    const bool whole = rb_first >= ch0 && rb_end <= ch1;
    const int n_groups = (seg_end - ch) * groups_per_chunk;
    for (int q = warp; q < n_groups; q += NWARPS) {
      const int c = ch + q / groups_per_chunk;
      const int off = (q % groups_per_chunk) * 32 + lane;
      const int* e = edges + static_cast<size_t>(c) * 3 * eb;
      const int rl = e[off];
      const int cl = e[eb + off];
      const float v = __int_as_float(e[2 * eb + off]);
      unsigned live = __ballot_sync(FULL, v != 0.f);
      if (!live) continue;
      const float* xc = x + static_cast<size_t>(ct_ids[c]) * ct * k + k0 + lane;
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
        const float* xr = xc + static_cast<size_t>(cj) * k;
#pragma unroll
        for (int t = 0; t < NK; ++t)
          if (live_f[t]) sum[t] = fmaf(vj, xr[32 * t], sum[t]);
      }
      add_row(row, sum);
    }
    __syncthreads();
    const int row0 = r * rb;
    for (int i = threadIdx.x; i < rb * KT; i += THREADS) {
      const float s = acc[i];
      acc[i] = 0.f;
      const int rr = row0 + i / KT, f = k0 + i % KT;
      if (rr >= num_rows || f >= k) continue;
      float* o = out + static_cast<size_t>(rr) * k + f;
      if (whole)
        *o = s;
      else if (s != 0.f)
        atomicAdd(o, s);
    }
    __syncthreads();
    ch = seg_end;
  }
}

template <int NK>
size_t smem_bytes(int rb) {
  return static_cast<size_t>(rb) * 32 * NK * sizeof(float);
}

template <int NK>
int launch(const void* edges, const void* rb_ids, const void* ct_ids,
           const void* chunk_starts, const void* x, void* out, int nc, int eb,
           int rb, int ct, int num_rows, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes<NK>(rb);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_rowblock_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nc + CHUNKS_PER_CTA - 1) / CHUNKS_PER_CTA,
                  (k + 32 * NK - 1) / (32 * NK));
  spmm_rowblock_kernel<NK><<<grid, THREADS, smem, stream>>>(
      static_cast<const int*>(edges), static_cast<const int*>(rb_ids),
      static_cast<const int*>(ct_ids), static_cast<const int*>(chunk_starts),
      static_cast<const float*>(x), static_cast<float*>(out), nc, eb, rb, ct,
      num_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32, zeroed by the caller, = the plan's edges times x
// (num_cols, k) fp32, on CUDA device `device` and stream `stream`.  K tiles
// of 64 features (two a lane) where K > 32 and the accumulator fits 100 KB
// of shared memory, so that two blocks share an SM; else 32.  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int spmm_rowblock_launch(const void* edges, const void* rb_ids,
                                    const void* ct_ids,
                                    const void* chunk_starts, const void* x,
                                    void* out, int nc, int eb, int rb, int ct,
                                    int num_rows, int k, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 32 && smem_bytes<2>(rb) <= 100 * 1024)
    return launch<2>(edges, rb_ids, ct_ids, chunk_starts, x, out, nc, eb, rb,
                     ct, num_rows, k, s);
  return launch<1>(edges, rb_ids, ct_ids, chunk_starts, x, out, nc, eb, rb, ct,
                   num_rows, k, s);
}
