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
// What bounds it on an H100: HBM bytes of the bf16 blocks (32 KiB a member,
// read once per K tile); x is read once per group and the tensor-core work
// (2*128*128 operations per member and feature) is far below the bf16 rate.
// The design: one CTA per (group, K tile).  It converts its cell's x tile
// (128 x KT) to bf16 in shared memory once, then streams the group's members
// one 32 KiB block at a time, double-buffered with cp.async, through
// mma.sync m16n8k16 (8 warps x 16 rows; A fragments by a transposed ldmatrix
// of the stored Aᵀ, B fragments by a transposed ldmatrix of the x tile).  The
// TPU kernel kept a superblock's output resident across its sequential
// block-column grid; on Hopper the blocks of the several block-columns that
// feed one row block run in parallel, so each member's 128 x KT partial is
// added to the zeroed output with atomicAdd, and the sums are taken in an
// order that changes from run to run.  Group-pad members (all zero, rb_local
// 0, after a cell's real members, whose rb_locals strictly increase) are
// skipped: neither read nor multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace bf16mma;

constexpr int BS = 128;
constexpr int THREADS = 256;      // 8 warps, 16 output rows of a member each
constexpr int A_STRIDE = BS + 8;  // bf16 per smem row of a member: 272 B,
                                  // so ldmatrix rows hit distinct banks

template <int KT>
struct Smem {
  static constexpr int X_STRIDE = KT + 8;  // bf16 per row of the x tile
  static constexpr int A_BYTES = BS * A_STRIDE * 2;
  static constexpr int X_BYTES = BS * X_STRIDE * 2;
  static constexpr int BYTES = 2 * A_BYTES + X_BYTES;
};

template <int KT>
__global__ void __launch_bounds__(THREADS)
    spmm_bsr_v3_kernel(const __nv_bfloat16* __restrict__ blocks,
                       const int* __restrict__ rb_locals,
                       const int* __restrict__ cell_starts,
                       const float* __restrict__ x, float* __restrict__ out,
                       int n_cells, int n_bc, int nrb_s, int g, int num_rows,
                       int num_cols, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = Smem<KT>::X_STRIDE;
  constexpr int NT = KT / 8;  // n-tiles of the m16n8k16 product
  __nv_bfloat16* x_s =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * Smem<KT>::A_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = blockIdx.x, k0 = blockIdx.y * KT;

  // the cell of this group: the last whose first group is <= grp (an empty
  // cell shares its first group with the next one)
  int lo = 0, hi = n_cells;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cell_starts[mid] <= grp)
      lo = mid;
    else
      hi = mid;
  }
  const int s = lo / n_bc, bc = lo % n_bc;
  const int m0 = grp * g, cell_m0 = cell_starts[lo] * g;
  int n_real = g;  // members before the first group pad
  for (int j = 0; j < g; ++j) {
    const int m = m0 + j;
    if (m > cell_m0 && rb_locals[m] <= rb_locals[m - 1]) {
      n_real = j;
      break;
    }
  }
  if (n_real == 0) return;

  const size_t group_stride = static_cast<size_t>(BS) * g * BS;
  auto stage = [&](int j, int buf) {
    __nv_bfloat16* a_s =
        reinterpret_cast<__nv_bfloat16*>(smem + buf * Smem<KT>::A_BYTES);
    const __nv_bfloat16* a_g = blocks + grp * group_stride + j * BS;
#pragma unroll
    for (int i = 0; i < BS * BS / 8 / THREADS; ++i) {  // 16-byte chunks
      const int q = tid + i * THREADS;
      const int c = q >> 4, r = (q & 15) * 8;
      cp_async16(a_s + c * A_STRIDE + r,
                 a_g + static_cast<size_t>(c) * g * BS + r);
    }
  };
  stage(0, 0);
  cp_async_commit();

  // the cell's x tile in bf16, rounded once: x_s[c][f] = x[bc*128 + c, k0 + f]
  for (int q = tid; q < BS * KT; q += THREADS) {
    const int c = q / KT, f = q % KT;
    const int col = bc * BS + c, ff = k0 + f;
    const float v =
        (col < num_cols && ff < k) ? x[static_cast<size_t>(col) * k + ff] : 0.f;
    x_s[c * XS + f] = __float2bfloat16_rn(v);
  }

  for (int j = 0; j < n_real; ++j) {
    if (j + 1 < n_real) {
      stage(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(
        smem + (j & 1) * Smem<KT>::A_BYTES);
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BS / 16; ++ks) {
      // A (rows r of the warp, depth c): Aᵀ rows c, transposed; matrix q
      // covers rows +8*(q&1) and depth +8*(q>>1)
      uint32_t a[4];
      ldmatrix_x4_trans(a, a_s + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     A_STRIDE +
                               warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // B (depth c, features f) of n-tiles nt and nt+1: matrix q covers
        // depth +8*(q&1) and features +8*(q>>1)
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, x_s + (ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * XS +
                   nt * 8 + ((lane >> 4) << 3));
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
    }
    const int r0 = (s * nrb_s + rb_locals[m0 + j]) * BS + warp * 16 +
                   (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int f = k0 + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        if (r >= num_rows) continue;
        float* o = out + static_cast<size_t>(r) * k;
        if (f < k) atomicAdd(o + f, acc[nt][2 * h]);
        if (f + 1 < k) atomicAdd(o + f + 1, acc[nt][2 * h + 1]);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
}

template <int KT>
int launch(const void* blocks, const void* rb_locals, const void* cell_starts,
           const void* x, void* out, int n_groups, int n_cells, int n_bc,
           int nrb_s, int g, int num_rows, int num_cols, int k,
           cudaStream_t stream) {
  const int smem = Smem<KT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      spmm_bsr_v3_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_groups, (k + KT - 1) / KT);
  spmm_bsr_v3_kernel<KT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const int*>(rb_locals), static_cast<const int*>(cell_starts),
      static_cast<const float*>(x), static_cast<float*>(out), n_cells, n_bc,
      nrb_s, g, num_rows, num_cols, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (num_rows, k) fp32 += the plan's dense blocks times x (num_cols, k)
// fp32, on CUDA device `device` and stream `stream`; K tiles of up to 128.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int spmm_bsr_v3_launch(const void* blocks, const void* rb_locals,
                                  const void* cell_starts, const void* x,
                                  void* out, int n_groups, int n_cells,
                                  int n_bc, int nrb_s, int g, int num_rows,
                                  int num_cols, int k, int device,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    return launch<32>(blocks, rb_locals, cell_starts, x, out, n_groups,
                      n_cells, n_bc, nrb_s, g, num_rows, num_cols, k, st);
  if (k <= 64)
    return launch<64>(blocks, rb_locals, cell_starts, x, out, n_groups,
                      n_cells, n_bc, nrb_s, g, num_rows, num_cols, k, st);
  if (k <= 96)
    return launch<96>(blocks, rb_locals, cell_starts, x, out, n_groups,
                      n_cells, n_bc, nrb_s, g, num_rows, num_cols, k, st);
  return launch<128>(blocks, rb_locals, cell_starts, x, out, n_groups,
                     n_cells, n_bc, nrb_s, g, num_rows, num_cols, k, st);
}
