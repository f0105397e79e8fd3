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
// What bounds it on an H100: at small K the HBM bytes of the bf16 blocks
// (32 KiB a block); at K = 602 the copies of each block's bf16 x tile into
// shared memory (from L2), 2.5 times the block at a K tile of 320.  The
// tensor-core work (2*128*128 operations per block and feature) is far
// below the card's bf16 rate.  The design this replaced (one CTA per
// (block-row, K tile), K tiles of at most 128, an fp32 x tile per block
// converted to bf16 in the inner loop: 0.5655 ms at K = 32 and 4.1138 ms
// at K = 602 on density-rep, 3.0915 ms at K = 602 on reddit-sim) lasted
// as long as its longest block-row (293 blocks on density-rep's R-MAT
// hub, median 4) and left SMs idle where block-rows are fewer than SMs.
//
// The design is K9's walk (bsr_walk.cuh): one owner per block-row.  The
// plan's schedule (HybridPlan.sched, derived once per plan) cuts the
// block-rows into pieces of at most PIECE_BLOCKS blocks, longest first; a
// CTA takes one (piece, K tile), streams its blocks (a plain ldmatrix of
// the row-major block gives the A fragments) and bf16 x tiles through a
// ring of cp.async stages, keeps the 128 x KT sum in registers and stores
// its block-row once; the pieces of a split block-row add into a zeroed
// output with atomics.  A call is two launches: a pre-pass rounds x to
// bf16 once and zeroes the block-rows without blocks and the split ones,
// then the walk.

#include "bsr_walk.cuh"

// out (num_rows, k) fp32 = the plan's dense blocks times x (num_cols, k)
// fp32, on CUDA device `device` and stream `stream`.  xb is a (c_pad, k8)
// bf16 scratch (c_pad = the block columns times 128, k8 = k rounded up to
// 8); out need not be zeroed.  Launches the pre-pass, then the walk over
// the n_pieces pieces.  Returns the CUDA error of the launches (0 =
// launched).
extern "C" int spmm_bsr_launch(const void* blocks, const void* members,
                               const void* pieces, const void* zero_rbs,
                               const void* x, void* xb, void* out,
                               int n_pieces, int n_zero, int num_rows,
                               int num_cols, int c_pad, int k, int device,
                               void* stream) {
  const bsrwalk::RowMajor<64> layout{
      static_cast<const __nv_bfloat16*>(blocks)};
  return bsrwalk::run(layout, members, pieces, zero_rbs, x, xb, out,
                      n_pieces, n_zero, num_rows, num_cols, c_pad, k, device,
                      stream);
}
