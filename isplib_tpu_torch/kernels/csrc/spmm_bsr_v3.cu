// Sum-SpMM over the dense blocks of a v3 celled BSR plan
// (isplib_tpu_torch.kernels.spmm_bsr_v3, the dense half of a v3 hybrid).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_bsr.py::_bsr_kernel
// (entries spmm_bsr and spmm_hybrid).  Same function: the plan's blocks are
// 128x128 bf16 tiles of A in groups of g, group b's member j stored as Aᵀ at
// lane band j (blocks[b, c, j*128 + r] = A[r, c] within the block); member
// m = b*g + j of cell (s, bc) adds into row block s*nrb_s + rb_locals[m]:
//     out[(s*nrb_s + rbl)*128 + r, k] += sum_c A[r, c] * bf16(x[bc*128 + c, k])
// with x rounded to bf16 as the TPU kernel rounds it, fp32 accumulation.
//
// What bounds it on an H100: what it copies into shared memory.  At small
// K that is the bf16 blocks from HBM (32 KiB a real member); at K = 602 it
// is each member's bf16 x tile, 2.5 times its block at a K tile of 320,
// from L2, and the blocks again in each K tile.  On density-rep's v3 plan
// (13,076 real members) the copies alone take 0.17 of 0.18 ms at K = 32 and
// three quarters of the time at K = 602 (probe_bsr_v3.py); the
// tensor-core work (2*128*128 operations per member and feature) is far
// below the bf16 rate.  The design this replaced (one CTA per (group, K
// tile), every member's 128 x KT partial added to the output with global
// atomicAdd: 0.4042 ms at K = 32, 6.3659 ms at K = 602 on density-rep) was
// bound by those atomics, 13,076 x 128 x K of them.
//
// The design: one owner per row block.  The plan's schedule (BSRSchedule,
// derived once per plan) lists the real members by (row block, block
// column) in pieces of at most 32; a CTA takes one (piece, K tile), streams
// its members' blocks and bf16 x tiles through a ring of cp.async stages,
// multiplies them on the tensor cores (mma.sync m16n8k16; A fragments by a
// transposed ldmatrix of the stored Aᵀ, B by a transposed ldmatrix of the x
// tile) and keeps the 128 x KT sum in registers across the piece.  It then
// stores its row block once; only the pieces of a row block that is split
// (R-MAT hubs) add into a zeroed output with atomics (float2 where K is
// even), one 128 x KT tile a piece.  K tiles are as wide as 320 (two warps
// over rows, four over features, 160 fp32 accumulators a thread), so
// K = 602 copies each block twice where the old design read it five
// times.  A stage holds half a member's depth (64 rows of its block and
// of its x tile; 58 KiB at a K tile of 320), the ring three to six
// stages, and the piece's member list sits in shared memory, so no copy
// waits on an index load.  A call is two launches: a pre-pass rounds x
// to bf16 once (row-padded, K padded to 8, so the tiles copy with 16-byte
// cp.async) and zeroes the row blocks that the walk does not store whole
// (no members, or split); then the walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace bf16mma;

constexpr int BS = 128;
constexpr int THREADS = 256;      // 8 warps
constexpr int MAX_PIECE = 64;     // members a piece holds at most (the
                                  // schedule's derivation enforces it)
constexpr int A_STRIDE = BS + 8;  // bf16 per smem row of a block: 272 B,
                                  // so ldmatrix rows hit distinct banks

// float2 atomicAdd on global memory (compute capability 9.x, CUDA 12.1+)
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
#define F2_ATOMIC 1
#else
#define F2_ATOMIC 0
#endif

// 16-byte copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// KT features a CTA, WM warps over the block's rows and 8/WM over the
// features; a stage of the cp.async ring holds DEPTH of a member's 128
// depth rows (of its block and of its x tile), the ring STAGES of them;
// MINB CTAs an SM.
template <int KT, int WM, int DEPTH, int STAGES, int MINB>
struct Cfg {
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BS / WM / 16;  // m16 tiles a warp
  static constexpr int NW = KT / WN;       // features a warp
  static constexpr int NT = NW / 8;        // n8 tiles a warp
  static constexpr int X_STRIDE = KT + 8;  // bf16 per smem row of an x tile
  static constexpr int PARTS = BS / DEPTH;  // stages a member
  static constexpr int A_BYTES = DEPTH * A_STRIDE * 2;
  static constexpr int X_BYTES = DEPTH * X_STRIDE * 2;
  static constexpr int STAGE_BYTES = A_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(NT % 2 == 0, "B fragments load in pairs of n8 tiles");
};

template <int KT, int WM, int DEPTH, int STAGES, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    spmm_bsr_v3_kernel(const __nv_bfloat16* __restrict__ blocks,
                       const int2* __restrict__ members,
                       const int4* __restrict__ pieces,
                       const __nv_bfloat16* __restrict__ xb,
                       float* __restrict__ out, int g, int num_rows, int k,
                       int k8) {
  using C = Cfg<KT, WM, DEPTH, STAGES, MINB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int k0 = blockIdx.y * KT;
  const int4 pc = pieces[blockIdx.x];  // first, end, row block, split
  const int n = (pc.y - pc.x) * C::PARTS;  // steps: members x parts
  const size_t group_stride = static_cast<size_t>(BS) * g * BS;
  // the piece's members, read once, so no copy waits on a member index
  __shared__ int2 piece_s[MAX_PIECE];
  for (int i = tid; i < pc.y - pc.x; i += THREADS)
    piece_s[i] = members[pc.x + i];
  __syncthreads();

  // step i: depth rows [c0, c0 + DEPTH) of member i / PARTS
  auto stage = [&](int i, int buf) {
    unsigned char* base = smem + buf * C::STAGE_BYTES;
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(base + C::A_BYTES);
    const int2 mb = piece_s[i / C::PARTS];  // member, block column
    const int c0 = (i % C::PARTS) * DEPTH;
    const __nv_bfloat16* a_g = blocks + (mb.x / g) * group_stride +
                               static_cast<size_t>(c0) * g * BS +
                               (mb.x % g) * BS;
#pragma unroll
    for (int q = tid; q < DEPTH * BS / 8; q += THREADS) {  // 16-byte chunks
      const int c = q >> 4, r = (q & 15) * 8;
      cp_async16(a_s + c * A_STRIDE + r,
                 a_g + static_cast<size_t>(c) * g * BS + r);
    }
    const __nv_bfloat16* x_g =
        xb + (static_cast<size_t>(mb.y) * BS + c0) * k8;
#pragma unroll
    for (int q = tid; q < DEPTH * KT / 8; q += THREADS) {
      const int c = q / (KT / 8), f = (q % (KT / 8)) * 8;
      const bool in = k0 + f < k8;
      cp_async16_zfill(x_s + c * C::X_STRIDE + f,
                       in ? x_g + static_cast<size_t>(c) * k8 + k0 + f : xb,
                       in ? 16 : 0);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int row_w = wm * (BS / WM);  // the warp's first row in the block
  const int col_w = wn * C::NW;      // and first feature in the K tile
  const bool live = k0 + col_w < k;  // a warp wholly past K only copies

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with i - 1
    if (i + STAGES - 1 < n) stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    if (!live) continue;
    const unsigned char* base = smem + (i % STAGES) * C::STAGE_BYTES;
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* x_s =
        reinterpret_cast<const __nv_bfloat16*>(base + C::A_BYTES);
#pragma unroll
    for (int ks = 0; ks < DEPTH / 16; ++ks) {
      // A (rows r, depth c) from the stored Aᵀ rows c, transposed: matrix q
      // covers rows +8*(q&1) and depth +8*(q>>1)
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldmatrix_x4_trans(
            a[mt], a_s + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                             A_STRIDE +
                       row_w + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < C::NT; nt += 2) {
        if (k0 + col_w + nt * 8 < k) {  // columns past K are zero
          // B (depth c, features f) of n-tiles nt and nt+1: matrix q covers
          // depth +8*(q&1) and features +8*(q>>1)
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, x_s + (ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                           C::X_STRIDE +
                     col_w + nt * 8 + ((lane >> 4) << 3));
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // one store of the row block (or one atomic add of a split piece's part)
  const bool split = pc.w != 0;
  const bool pairs = (k & 1) == 0;  // float2 stores are 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = pc.z * BS + row_w + mt * 16 + (lane >> 2) + h * 8;
      if (r >= num_rows) continue;
      float* o = out + static_cast<size_t>(r) * k;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int f = k0 + col_w + nt * 8 + 2 * (lane & 3);
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (split) {
#if F2_ATOMIC
          if (pairs && f + 1 < k) {
            atomicAdd(reinterpret_cast<float2*>(o + f), make_float2(v0, v1));
            continue;
          }
#endif
          if (f < k) atomicAdd(o + f, v0);
          if (f + 1 < k) atomicAdd(o + f + 1, v1);
        } else if (pairs && f + 1 < k) {
          *reinterpret_cast<float2*>(o + f) = make_float2(v0, v1);
        } else {
          if (f < k) o[f] = v0;
          if (f + 1 < k) o[f + 1] = v1;
        }
      }
    }
  }
}

// xb (c_pad, k8) bf16 = x (num_cols, k) rounded to nearest, zero past the
// x's rows and features; and the row blocks zero_rbs of out set to 0.
__global__ void __launch_bounds__(THREADS)
    prepass_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                   const int* __restrict__ zero_rbs, float* __restrict__ out,
                   int num_cols, int c_pad, int k, int k8, int n_zero,
                   int num_rows) {
  const size_t stride = static_cast<size_t>(gridDim.x) * THREADS;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int per_row = k8 / 8;
  const size_t n8 = static_cast<size_t>(c_pad) * per_row;
  for (size_t q = t0; q < n8; q += stride) {
    const int r = static_cast<int>(q / per_row);
    const int f = static_cast<int>(q % per_row) * 8;
    const float* xr = x + static_cast<size_t>(r) * k;
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f0 = f + 2 * t;
      const float lo = (r < num_cols && f0 < k) ? xr[f0] : 0.f;
      const float hi = (r < num_cols && f0 + 1 < k) ? xr[f0 + 1] : 0.f;
      w[t] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(xb + static_cast<size_t>(r) * k8 + f) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  const size_t tile = static_cast<size_t>(BS) * k;
  const size_t limit = static_cast<size_t>(num_rows) * k;
  const size_t nz = static_cast<size_t>(n_zero) * tile;
  for (size_t q = t0; q < nz; q += stride) {
    const size_t at = static_cast<size_t>(zero_rbs[q / tile]) * tile +
                      q % tile;
    if (at < limit) out[at] = 0.f;
  }
}

template <int KT, int WM, int DEPTH, int STAGES, int MINB>
int launch_walk(const void* blocks, const void* members, const void* pieces,
                const void* xb, void* out, int n_pieces, int g, int num_rows,
                int k, int k8, cudaStream_t stream) {
  using C = Cfg<KT, WM, DEPTH, STAGES, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      spmm_bsr_v3_kernel<KT, WM, DEPTH, STAGES, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pieces, (k + KT - 1) / KT);
  spmm_bsr_v3_kernel<KT, WM, DEPTH, STAGES, MINB><<<grid, THREADS, C::SMEM,
                                                    stream>>>(
      static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const int2*>(members), static_cast<const int4*>(pieces),
      static_cast<const __nv_bfloat16*>(xb), static_cast<float*>(out), g,
      num_rows, k, k8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32 = the plan's dense blocks times x (num_cols, k)
// fp32, on CUDA device `device` and stream `stream`.  xb is a (c_pad, k8)
// bf16 scratch (c_pad = the plan's padded columns, k8 = k rounded up to 8);
// out need not be zeroed.  Launches the pre-pass, then the walk over the
// n_pieces pieces.  Returns the CUDA error of the launches (0 = launched).
extern "C" int spmm_bsr_v3_launch(const void* blocks, const void* members,
                                  const void* pieces, const void* zero_rbs,
                                  const void* x, void* xb, void* out,
                                  int n_pieces, int n_zero, int g,
                                  int num_rows, int num_cols, int c_pad,
                                  int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k8 = (k + 7) / 8 * 8;
  const size_t work = static_cast<size_t>(c_pad) * (k8 / 8) +
                      static_cast<size_t>(n_zero) * BS * k;
  size_t blocks_needed = (work + THREADS - 1) / THREADS;
  if (blocks_needed > 132 * 16) blocks_needed = 132 * 16;
  if (blocks_needed == 0) blocks_needed = 1;
  const int grid = static_cast<int>(blocks_needed);
  prepass_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(xb),
      static_cast<const int*>(zero_rbs), static_cast<float*>(out), num_cols,
      c_pad, k, k8, n_zero, num_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_pieces == 0) return static_cast<int>(err);
  if (k <= 32)
    return launch_walk<32, 8, 64, 4, 2>(blocks, members, pieces, xb, out,
                                    n_pieces, g, num_rows, k, k8, st);
  if (k <= 64)
    return launch_walk<64, 4, 64, 4, 2>(blocks, members, pieces, xb, out,
                                    n_pieces, g, num_rows, k, k8, st);
  if (k <= 128)
    return launch_walk<128, 4, 64, 6, 1>(blocks, members, pieces, xb, out,
                                     n_pieces, g, num_rows, k, k8, st);
  if (k <= 256)
    return launch_walk<256, 2, 64, 4, 1>(blocks, members, pieces, xb, out,
                                     n_pieces, g, num_rows, k, k8, st);
  return launch_walk<320, 2, 64, 3, 1>(blocks, members, pieces, xb, out,
                                   n_pieces, g, num_rows, k, k8, st);
}
