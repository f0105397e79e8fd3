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
// What bounds it on an H100: the gathered x rows (K*4 B a real slot, served
// from L2 while the K tile's slice of x fits its 50 MB) and the latency of
// those gathers; the plan's planes are 12 B a slot and two operations per
// slot and feature are far below the fp32 peak.  The design this replaced
// (a CTA per run of 32 chunks and K tile of 32 or 64, each warp walking its
// slots one at a time with one x-row gather in flight, pads read and
// skipped, an rb x KT shared accumulator fed by shared atomics: 0.8103 ms
// at K = 32, 9.3745 ms at K = 602 on density-rep) waited on latency at 1-4%
// of bound.
//
// The design (row_walk.cuh, shared with K8): rows are owned, and many
// gathers are in flight.  The plan's schedule (RowSchedule, derived once
// per plan) lists each row's real slots in order, one int32 a slot, so
// pads are never read, and cuts rows into work items of at most 256
// slots.  A warp takes one item and one K tile of up to 128 features, so
// K = 602 walks the slots five times where the old design walked them
// ten; its lanes decode 32 slots at once and broadcast them with shuffles,
// with up to eight x-row gathers in flight.  The sum stays in registers;
// a row that is one item is stored once, the items of a split row add
// with atomicAdd into the zeroed output.

#include "row_walk.cuh"

// out (num_rows, k) fp32, zeroed by the caller, = the plan's edges times x
// (num_cols, k) fp32, walking the plan's schedule, on CUDA device `device`
// and stream `stream`.  K tiles of up to 128 features (1-4 a lane).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int spmm_rowblock_launch(const void* edges, const void* ct_ids,
                                    const void* order, const void* row_ptr,
                                    const void* seg_ptr, const void* seg_row,
                                    const void* x, void* out, int nseg,
                                    int eb, int ct, int k, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rowwalk::V1Slots slots{static_cast<const int*>(edges),
                               static_cast<const int*>(ct_ids), eb, ct};
  return rowwalk::run<false, 4>(slots, order, row_ptr, seg_ptr, seg_row, x,
                                out, nseg, k,
                                static_cast<cudaStream_t>(stream));
}
