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
// What bounds it on an H100: the gathered x rows (K*4 B a real slot, from
// L2) and the latency of those gathers; the real slots' planes and the
// output are the HBM bytes, and two operations per slot and feature are far
// below the fp32 peak.  The design this replaced (v2_cell.cuh: a CTA per
// run of 8 chunks and K tile of 32 or 64, the cell's x tile loaded
// synchronously at every cell change, every slot read, pads included, one
// live slot at a time per warp, an rb x KT shared accumulator fed by
// shared atomics and flushed into a zeroed output with global atomics:
// 0.0751 ms at K = 32 and 0.7334 ms at K = 602 on reddit-sim's shard 0)
// read the version-3 residual's 40.7M slots for 2.06M real edges, in up to
// nineteen K tiles at K = 602.
//
// The design is K10's walk (row_walk.cuh): rows are owned, and many gathers
// are in flight.  The plan's schedule (RowScheduleV2, derived once per plan)
// lists each row's real slots as flat indices, so pads are never read, cuts
// rows into work items of at most 64 slots (four times K10's 256: a shard's
// dense rows then spread over four times the warps), and gives each chunk's
// column offset, so a slot decodes with no search for its cell.  A warp takes
// one item and one K tile of up to 160 features (K = 602 in four passes; tiles
// of 128, five passes, and of 256 or 320 were slower: probe_bsr_v3.py),
// decodes 32 slots at once and broadcasts them with shuffles, with up to eight
// x-row gathers in flight, and keeps the sum in registers.  Two output modes.
// Write (versions 2 and the sharded route, out = None in the wrapper): a
// pre-pass zeroes the rows without slots and the split rows, then the walk
// stores each row of one item once and adds a split row's items with atomics,
// so no zeroed output is made first.  Add (the version-3 residual, into K9's
// output): the one warp that owns an unsplit row reads, adds and stores it;
// split rows add with atomics; rows without slots are left alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_walk.cuh"

namespace {

// the rows zero_rows of out (num_rows, k) set to 0
__global__ void __launch_bounds__(rowwalk::THREADS)
    zero_rows_kernel(const int* __restrict__ zero_rows,
                     float* __restrict__ out, int n_zero, int k) {
  const size_t n = static_cast<size_t>(n_zero) * k;
  const size_t stride = static_cast<size_t>(gridDim.x) * rowwalk::THREADS;
  for (size_t q = static_cast<size_t>(blockIdx.x) * rowwalk::THREADS +
                  threadIdx.x;
       q < n; q += stride)
    out[static_cast<size_t>(zero_rows[q / k]) * k + q % k] = 0.f;
}

}  // namespace

// out (num_rows, k) fp32 = (add: +=) the plan's edges times x (num_cols, k)
// fp32, walking the plan's schedule, on CUDA device `device` and stream
// `stream`.  Without add, out need not be zeroed: the n_zero rows
// zero_rows (those without slots, and the split ones) are zeroed first,
// one more launch.  K tiles of up to 160 features.  Returns the CUDA error
// of the launches (0 = launched).
extern "C" int spmm_v2_launch(const void* edges, const void* chunk_col,
                              const void* order, const void* row_ptr,
                              const void* seg_ptr, const void* seg_row,
                              const void* zero_rows, const void* x, void* out,
                              int nseg, int n_zero, int eb, int k, int add,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!add && n_zero > 0) {
    const size_t n = static_cast<size_t>(n_zero) * k;
    size_t blocks = (n + rowwalk::THREADS - 1) / rowwalk::THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    zero_rows_kernel<<<static_cast<int>(blocks), rowwalk::THREADS, 0, st>>>(
        static_cast<const int*>(zero_rows), static_cast<float*>(out), n_zero,
        k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nseg == 0) return 0;
  const rowwalk::V2Slots slots{static_cast<const int*>(edges),
                               static_cast<const int*>(chunk_col), eb};
  if (add)
    return rowwalk::run<true, 5>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                 out, nseg, k, st);
  return rowwalk::run<false, 5>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                out, nseg, k, st);
}
