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
// The design (bsr_walk.cuh, shared with K2): one owner per row block.  The
// plan's schedule (BSRSchedule, derived once per plan) lists the real
// members by (row block, block column) in pieces of at most 32; a CTA
// takes one (piece, K tile), streams its members' blocks and bf16 x tiles
// through a ring of cp.async stages (A fragments by a transposed ldmatrix
// of the stored Aᵀ), keeps the 128 x KT sum in registers across the piece
// and stores its row block once; the pieces of a split row block add into
// a zeroed output with atomics.  K tiles are as wide as 320, so K = 602
// copies each block twice where the old design read it five times.  A
// call is two launches: a pre-pass (x to bf16 once, the row blocks not
// stored whole zeroed), then the walk.

#include "bsr_walk.cuh"

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
  const bsrwalk::LaneBands<64> layout{
      static_cast<const __nv_bfloat16*>(blocks), g};
  return bsrwalk::run(layout, members, pieces, zero_rbs, x, xb, out,
                      n_pieces, n_zero, num_rows, num_cols, c_pad, k, device,
                      stream);
}
