// Max/min SpMM with the winning edge id per (row, feature) over a with-eids
// v2 cell plan (isplib_tpu_torch.kernels.spmm_minmax).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_minmax.py::_minmax_kernel
// (entry spmm_minmax_tiled).  Same function: for every row r and feature k,
//     out[r, k] = max over the plan's edges e of row r of val[e] * x[col, k]
//     arg[r, k] = the lowest edge id (plane 3) that attains it
// and for min the same on the negated products; pad slots (id -1) take no
// part, value-0 edges do (their product is 0).  It is exact fp32 (one
// multiply and one compare per edge and feature).  Empty rows give out = 0
// and arg = sentinel.  out is the winner's product with a zero made +0.0
// before the sign of min is put back, as the TPU kernel's exact one-hot
// moves give it; the plain version computes the same bits.
//
// What bounds it on an H100: the instructions per slot and feature and the
// x rows each real slot reads; HBM bytes are the real slots' planes 0, 1
// and 3 (12 B a slot), the schedule and out + arg.  The design is the
// shared max/min walk (minmax_walk.cuh) over the plan's schedule
// (TiledPlanV2.mm_sched, derived once per with-eids plan): its real slots
// alone, by (row, id), gathered by warps that own up to N slots of a
// row.  The design this replaced walked the plan's cells: every slot of
// every chunk read, pads included, for every K tile of 32 or 64 features; one live slot at a time per warp; 64-bit shared
// atomics at every row change, global atomics into an (R, K) scratch that
// the wrapper zeroed, and a second kernel that decoded all R x K keys
// (0.1174 / 1.4990 ms at K = 32 / 602 on reddit-sim's shard 0 local plan,
// NVIDIA H100 80GB HBM3 at 700 W).
//
// The decoder: a ref is a flat slot index chunk*eb + slot of the plan's
// edges (planes: 0 the column within the chunk's tile, 1 the value's bits,
// 3 the edge id), the chunk's first column from the schedule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minmax_walk.cuh"

namespace {

struct V2Edges {
  const int* edges;
  const int* chunk_col;
  int eb;

  __device__ __forceinline__ void edge(int ref, int& c, float& v,
                                       int& id) const {
    const int ch = ref / eb, s = ref - ch * eb;
    const int* e = edges + static_cast<size_t>(ch) * 4 * eb + s;
    c = __ldg(chunk_col + ch) + __ldg(e);
    v = __int_as_float(__ldg(e + eb));
    id = __ldg(e + 3 * eb);
  }
  // a zero winner as +0.0 before the sign of min is put back
  __device__ __forceinline__ float final(float best, float sgn) const {
    return sgn * __fadd_rn(best, 0.f);
  }
  __device__ __forceinline__ float from_key(unsigned long long key, int,
                                            const float*, int,
                                            float sgn) const {
    return sgn * minmax_key_value(key);
  }
};

}  // namespace

// out (num_rows, k) fp32 and arg (num_rows, k) int32 = max (negate = 0) or
// min (negate = 1) SpMM of the with-eids plan's edges (nc + 8, 4, eb) int32
// walked by the schedule in `args` (mmwalk::Args), the chunks' first
// columns in `chunk_col`, on CUDA device `device` and stream `stream`.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int spmm_minmax_v2_launch(const void* edges, const void* chunk_col,
                                     int eb, const mmwalk::Args* args,
                                     int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const V2Edges dec{static_cast<const int*>(edges),
                    static_cast<const int*>(chunk_col), eb};
  return mmwalk::run(dec, *args, static_cast<cudaStream_t>(stream));
}
