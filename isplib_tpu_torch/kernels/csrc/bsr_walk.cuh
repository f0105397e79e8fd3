// The walk that the two dense-block kernels share: spmm_bsr.cu (K2, the v5
// hybrid's dense half) and spmm_bsr_v3.cu (K9, the v3 celled BSR).
//
// Both compute out[rb*128 + r, f] = sum over the row block's members m of
// sum_c A_m[r, c] * bf16(x[bc_m*128 + c, f]) with bf16 blocks and fp32
// accumulation, over a schedule that the plan layer derives once per plan
// (isplib_tpu_torch/sparse/tiling_v3.py, BSRSchedule): the members as
// (member, block column) pairs sorted by (row block, block column), and
// pieces (first, end, row block, split) of at most MAX_PIECE members, a
// hub row block's pieces marked split.  They differ only in where member
// m's 128x128 block lives and how its A fragment loads, which a block
// layout says (LaneBands for K9, RowMajor for K2).
//
// What bounds it on an H100: what it copies into shared memory.  At small
// K that is the bf16 blocks from HBM (32 KiB a member); at K = 602 it is
// each member's bf16 x tile, 2.5 times its block at a K tile of 320, from
// L2, and the blocks again in each K tile.  The tensor-core work
// (2*128*128 operations per member and feature) is far below the bf16
// rate.
//
// The design: one owner per row block.  A CTA takes one (piece, K tile),
// streams its members' blocks and bf16 x tiles through a ring of cp.async
// stages, multiplies them on the tensor cores (mma.sync m16n8k16; A
// fragments by ldmatrix as the layout says, B by a transposed ldmatrix of
// the x tile) and keeps the 128 x KT sum in registers across the piece.
// It then stores its row block once; only the pieces of a row block that
// is split (R-MAT hubs) add into a zeroed output with atomics (float2
// where K is even), one 128 x KT tile a piece.  K tiles are as wide as
// 320 (two warps over rows, four over features, 160 fp32 accumulators a
// thread), so K = 602 copies each block twice.  A stage holds half a
// member's depth (64 depth columns of its block and 64 rows of its x
// tile), the ring three to six stages, and the piece's member list sits
// in shared memory, so no copy waits on an index load.  A call is two
// launches: a pre-pass rounds x to bf16 once (row-padded, K padded to 8,
// so the tiles copy with 16-byte cp.async) and zeroes the row blocks that
// the walk does not store whole (no members, or split); then the walk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace bsrwalk {

using namespace bf16mma;

constexpr int BS = 128;
constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_PIECE = 64;  // members a piece holds at most (the
                               // schedule's derivation enforces it)

// float2 atomicAdd on global memory (compute capability 9.x, CUDA 12.1+)
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
#define BSRWALK_F2_ATOMIC 1
#else
#define BSRWALK_F2_ATOMIC 0
#endif

// 16-byte copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// K9's blocks: groups of g members, member j of group b stored as Aᵀ at
// lane band j (blocks[b, c, j*128 + r] = A[r, c]).  A stage holds depth
// rows [c0, c0 + DEPTH) of Aᵀ; A fragments load by a transposed ldmatrix.
template <int DEPTH_>
struct LaneBands {
  static constexpr int DEPTH = DEPTH_;
  static constexpr int A_STRIDE = BS + 8;  // bf16 per smem row: 272 B, so
                                           // ldmatrix rows hit distinct banks
  static constexpr int A_BYTES = DEPTH * A_STRIDE * 2;
  const __nv_bfloat16* blocks;
  int g;

  __device__ __forceinline__ void stage(__nv_bfloat16* a_s, int m, int c0,
                                        int tid) const {
    const __nv_bfloat16* a_g =
        blocks + (m / g) * (static_cast<size_t>(BS) * g * BS) +
        static_cast<size_t>(c0) * g * BS + (m % g) * BS;
#pragma unroll
    for (int q = tid; q < DEPTH * BS / 8; q += THREADS) {  // 16-byte chunks
      const int c = q >> 4, r = (q & 15) * 8;
      cp_async16(a_s + c * A_STRIDE + r,
                 a_g + static_cast<size_t>(c) * g * BS + r);
    }
  }

  // rows [row, row + 16) and depth [16 ks, 16 ks + 16) from the stored Aᵀ
  // rows, transposed: matrix q covers rows +8*(q&1) and depth +8*(q>>1)
  __device__ __forceinline__ void frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* a_s, int ks,
                                       int row, int lane) const {
    ldmatrix_x4_trans(
        a, a_s + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * A_STRIDE +
               row + ((lane >> 3) & 1) * 8);
  }
};

// K2's blocks: (nb, 128, 128) row-major, blocks[m, r, c] = A[r, c].  A
// stage holds depth columns [c0, c0 + DEPTH) of every row; A fragments
// load by a plain ldmatrix.
template <int DEPTH_>
struct RowMajor {
  static constexpr int DEPTH = DEPTH_;
  static constexpr int A_STRIDE = DEPTH + 8;  // bf16 per smem row: 144 B at
                                              // 64, conflict-free ldmatrix
  static constexpr int A_BYTES = BS * A_STRIDE * 2;
  const __nv_bfloat16* blocks;

  __device__ __forceinline__ void stage(__nv_bfloat16* a_s, int m, int c0,
                                        int tid) const {
    const __nv_bfloat16* a_g =
        blocks + static_cast<size_t>(m) * BS * BS + c0;
#pragma unroll
    for (int q = tid; q < BS * DEPTH / 8; q += THREADS) {  // 16-byte chunks
      const int r = q / (DEPTH / 8), c = (q % (DEPTH / 8)) * 8;
      cp_async16(a_s + r * A_STRIDE + c, a_g + r * BS + c);
    }
  }

  // rows [row, row + 16) and depth [16 ks, 16 ks + 16): matrix q covers
  // rows +8*(q&1) and depth +8*(q>>1)
  __device__ __forceinline__ void frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* a_s, int ks,
                                       int row, int lane) const {
    ldmatrix_x4(a, a_s + (row + (lane & 15)) * A_STRIDE + ks * 16 +
                       (lane >> 4) * 8);
  }
};

// KT features a CTA, WM warps over the block's rows and 8/WM over the
// features; a stage of the cp.async ring holds L::DEPTH of a member's 128
// depth (of its block and of its x tile), the ring STAGES of them; MINB
// CTAs an SM.
template <int KT, int WM, int STAGES, int MINB, class L>
struct Cfg {
  static constexpr int DEPTH = L::DEPTH;
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BS / WM / 16;  // m16 tiles a warp
  static constexpr int NW = KT / WN;       // features a warp
  static constexpr int NT = NW / 8;        // n8 tiles a warp
  static constexpr int X_STRIDE = KT + 8;  // bf16 per smem row of an x tile
  static constexpr int PARTS = BS / DEPTH;  // stages a member
  static constexpr int A_BYTES = L::A_BYTES;
  static constexpr int X_BYTES = DEPTH * X_STRIDE * 2;
  static constexpr int STAGE_BYTES = A_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(NT % 2 == 0, "B fragments load in pairs of n8 tiles");
  static_assert(A_BYTES % 16 == 0, "x tiles copy 16-byte aligned");
};

template <int KT, int WM, int STAGES, int MINB, class L>
__global__ void __launch_bounds__(THREADS, MINB)
    walk_kernel(const L layout, const int2* __restrict__ members,
                const int4* __restrict__ pieces,
                const __nv_bfloat16* __restrict__ xb,
                float* __restrict__ out, int num_rows, int k, int k8) {
  using C = Cfg<KT, WM, STAGES, MINB, L>;
  constexpr int DEPTH = C::DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int k0 = blockIdx.y * KT;
  const int4 pc = pieces[blockIdx.x];  // first, end, row block, split
  const int n = (pc.y - pc.x) * C::PARTS;  // steps: members x parts
  // the piece's members, read once, so no copy waits on a member index
  __shared__ int2 piece_s[MAX_PIECE];
  for (int i = tid; i < pc.y - pc.x; i += THREADS)
    piece_s[i] = members[pc.x + i];
  __syncthreads();

  // step i: depth [c0, c0 + DEPTH) of member i / PARTS
  auto stage = [&](int i, int buf) {
    unsigned char* base = smem + buf * C::STAGE_BYTES;
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(base + C::A_BYTES);
    const int2 mb = piece_s[i / C::PARTS];  // member, block column
    const int c0 = (i % C::PARTS) * DEPTH;
    layout.stage(a_s, mb.x, c0, tid);
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
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        layout.frag(a[mt], a_s, ks, row_w + mt * 16, lane);
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
#if BSRWALK_F2_ATOMIC
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

template <int KT, int WM, int STAGES, int MINB, class L>
int launch_walk(const L& layout, const void* members, const void* pieces,
                const void* xb, void* out, int n_pieces, int num_rows, int k,
                int k8, cudaStream_t stream) {
  using C = Cfg<KT, WM, STAGES, MINB, L>;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<KT, WM, STAGES, MINB, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pieces, (k + KT - 1) / KT);
  walk_kernel<KT, WM, STAGES, MINB, L><<<grid, THREADS, C::SMEM, stream>>>(
      layout, static_cast<const int2*>(members),
      static_cast<const int4*>(pieces),
      static_cast<const __nv_bfloat16*>(xb), static_cast<float*>(out),
      num_rows, k, k8);
  return static_cast<int>(cudaGetLastError());
}

// out (num_rows, k) fp32 = the schedule's blocks times x (num_cols, k)
// fp32, on CUDA device `device` and stream `stream`, blocks as `layout`
// (a LaneBands<64> or RowMajor<64>) holds them.  xb is a (c_pad, k8) bf16
// scratch (c_pad = the plan's padded columns, k8 = k rounded up to 8); out
// need not be zeroed.  Launches the pre-pass, then the walk over the
// n_pieces pieces.  Returns the CUDA error of the launches (0 = launched).
template <class L>
int run(const L& layout, const void* members, const void* pieces,
        const void* zero_rbs, const void* x, void* xb, void* out,
        int n_pieces, int n_zero, int num_rows, int num_cols, int c_pad,
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
    return launch_walk<32, 8, 4, 2>(layout, members, pieces, xb, out,
                                    n_pieces, num_rows, k, k8, st);
  if (k <= 64)
    return launch_walk<64, 4, 4, 2>(layout, members, pieces, xb, out,
                                    n_pieces, num_rows, k, k8, st);
  if (k <= 128)
    return launch_walk<128, 4, 6, 1>(layout, members, pieces, xb, out,
                                     n_pieces, num_rows, k, k8, st);
  if (k <= 256)
    return launch_walk<256, 2, 4, 1>(layout, members, pieces, xb, out,
                                     n_pieces, num_rows, k, k8, st);
  return launch_walk<320, 2, 3, 1>(layout, members, pieces, xb, out,
                                   n_pieces, num_rows, k, k8, st);
}

}  // namespace bsrwalk
