// Sum-SpMM over the dense 128x128 bf16 blocks of a hybrid plan (the dense
// half of isplib_tpu_torch.kernels.spmm_hybrid).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_bsr2.py::_bsr2_kernel
// (entries spmm_bsr2 / spmm_hybrid_v5).  Same function: for every dense
// block j of block-row br and block-col bc,
//     out[br*128 + r, k] += sum_c blocks[j, r, c] * bf16(x[bc*128 + c, k])
// with bf16 operands and fp32 accumulation.  Rows of a block-row that has
// no dense block are written as zeros, so the kernel writes every output
// row once and the residual kernel (spmm_stream.cu) adds into the result.
//
// What bounds it on an H100: HBM bytes of the bf16 blocks (32 KiB per block,
// read once per K tile); x (C*K*4 bytes) is re-read per block but stays in
// the 50 MB L2 at the main path's widths, and the tensor-core work (2*128*128
// operations per block and feature) is ~300x below the card's bf16 rate.
// The design therefore streams blocks: one CTA owns one (block-row, K tile)
// output tile of 128 x KT in fp32 registers, no atomics, and double-buffers
// the next block and its x tile with cp.async while the current pair runs
// through mma.sync m16n8k16 (8 warps x 16 rows).  K up to 128 is one tile,
// so the blocks are read once for both K = 32 and K = 41; the ragged K and
// the last block-col are zero-filled in shared memory, never in the caller's
// x.  Known limit of this simple form: one CTA per block-row leaves SMs idle
// when the graph has fewer dense block-rows than the card has SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace bf16mma;

constexpr int BS = 128;
constexpr int THREADS = 256;          // 8 warps, 16 output rows each
constexpr int A_STRIDE = BS + 8;      // bf16 per smem row of a block: 272 B,
                                      // so ldmatrix rows hit distinct banks

template <int KT>
struct Tile {
  // floats per smem row of the x tile; a stride of 4 (mod 32) words makes
  // the B-fragment reads of a warp conflict-free
  static constexpr int X_STRIDE = KT + 4;
  static constexpr int A_BYTES = BS * A_STRIDE * 2;
  static constexpr int X_BYTES = BS * X_STRIDE * 4;
  static constexpr int STAGE_BYTES = A_BYTES + X_BYTES;
  static constexpr int SMEM_BYTES = 2 * STAGE_BYTES;
};

// Issue the copies of block j and the x tile it multiplies into one stage.
template <int KT>
__device__ __forceinline__ void stage(unsigned char* buf,
                                      const __nv_bfloat16* __restrict__ blocks,
                                      const int* __restrict__ blk_col, int j,
                                      const float* __restrict__ x,
                                      int num_cols, int k, int k0, int tid) {
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(buf);
  float* x_s = reinterpret_cast<float*>(buf + Tile<KT>::A_BYTES);
  const __nv_bfloat16* a_g = blocks + static_cast<size_t>(j) * BS * BS;
#pragma unroll
  for (int i = 0; i < BS * BS / 8 / THREADS; ++i) {  // 16-byte chunks
    const int q = tid + i * THREADS;
    const int r = q >> 4, c = (q & 15) * 8;
    cp_async16(a_s + r * A_STRIDE + c, a_g + r * BS + c);
  }
  const int c0 = blk_col[j] * BS;
#pragma unroll 4
  for (int i = 0; i < BS * KT / THREADS; ++i) {
    const int q = tid + i * THREADS;
    const int c = q / KT, n = q % KT;
    const bool ok = (c0 + c < num_cols) && (k0 + n < k);
    const float* src = ok ? x + static_cast<size_t>(c0 + c) * k + k0 + n : x;
    cp_async4(x_s + c * Tile<KT>::X_STRIDE + n, src, ok ? 4 : 0);
  }
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
    spmm_bsr_kernel(const __nv_bfloat16* __restrict__ blocks,
                    const int* __restrict__ blk_rowptr,
                    const int* __restrict__ blk_col,
                    const float* __restrict__ x, float* __restrict__ out,
                    int num_rows, int num_cols, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = Tile<KT>::X_STRIDE;
  constexpr int NT = KT / 8;  // n-tiles of the m16n8k16 product
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int br = blockIdx.x, k0 = blockIdx.y * KT;
  const int j0 = blk_rowptr[br], n = blk_rowptr[br + 1] - j0;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (n > 0) {
    stage<KT>(smem, blocks, blk_col, j0, x, num_cols, k, k0, tid);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    unsigned char* cur = smem + (i & 1) * Tile<KT>::STAGE_BYTES;
    if (i + 1 < n) {
      stage<KT>(smem + ((i + 1) & 1) * Tile<KT>::STAGE_BYTES, blocks,
                blk_col, j0 + i + 1, x, num_cols, k, k0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(cur);
    const float* x_s =
        reinterpret_cast<const float*>(cur + Tile<KT>::A_BYTES);
#pragma unroll
    for (int ks = 0; ks < BS / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_s + (warp * 16 + (lane & 15)) * A_STRIDE + ks * 16 +
                         (lane >> 4) * 8);
      const float* xb = x_s + (ks * 16 + 2 * t) * XS + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = xb + nt * 8;
        const uint32_t b0 = pack_bf16(p[0], p[XS]);
        const uint32_t b1 = pack_bf16(p[8 * XS], p[9 * XS]);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const int r0 = br * BS + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int f = k0 + nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r >= num_rows) continue;
      float* o = out + static_cast<size_t>(r) * k;
      if (f < k) o[f] = acc[nt][2 * h];
      if (f + 1 < k) o[f + 1] = acc[nt][2 * h + 1];
    }
  }
}

template <int KT>
int launch(const void* blocks, const void* blk_rowptr, const void* blk_col,
           const void* x, void* out, int n_br, int num_rows, int num_cols,
           int k, void* stream) {
  const int smem = Tile<KT>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      spmm_bsr_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_br, (k + KT - 1) / KT);
  spmm_bsr_kernel<KT><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const int*>(blk_rowptr), static_cast<const int*>(blk_col),
      static_cast<const float*>(x), static_cast<float*>(out), num_rows,
      num_cols, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32 = dense half of the plan times x (num_cols, k) fp32,
// on CUDA device `device` and stream `stream`.  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int spmm_bsr_launch(const void* blocks, const void* blk_rowptr,
                               const void* blk_col, const void* x, void* out,
                               int n_br, int num_rows, int num_cols, int k,
                               int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k <= 32)
    return launch<32>(blocks, blk_rowptr, blk_col, x, out, n_br, num_rows,
                      num_cols, k, stream);
  if (k <= 64)
    return launch<64>(blocks, blk_rowptr, blk_col, x, out, n_br, num_rows,
                      num_cols, k, stream);
  if (k <= 96)
    return launch<96>(blocks, blk_rowptr, blk_col, x, out, n_br, num_rows,
                      num_cols, k, stream);
  return launch<128>(blocks, blk_rowptr, blk_col, x, out, n_br, num_rows,
                     num_cols, k, stream);
}
