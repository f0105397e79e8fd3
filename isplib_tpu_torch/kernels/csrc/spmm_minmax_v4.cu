// Max/min SpMM with the winning edge id per (row, feature)
// (isplib_tpu_torch.kernels.spmm_minmax_v4).
//
// Replaces the TPU kernel isplib_tpu/kernels/spmm_minmax_v4.py::_v4mm_kernel
// (entry spmm_minmax_v4).  Same function: for every row r and feature k,
//     out[r, k] = max_{e in row r} val[e] * x[col[e], k]
//     arg[r, k] = the lowest edge id e that attains it
// and for min the same on the negated products.  It is exact fp32 (one
// multiply and one compare per edge and feature, no sum), and out is the
// winning edge's own product, so the result equals the plain version bit for
// bit.  Empty rows give out = 0 and arg = sentinel (nnz_padded - 1, a pad
// edge through which no gradient flows).  An edge's id is its CSR position:
// the kernel reads the graph's own col and val at call time (val is
// differentiable), no copy of the edges.
//
// What bounds it on an H100: the instructions per edge and feature and the
// x rows gathered per edge (K*4 B an edge, from L2); HBM bytes are col +
// val (8 B an edge), the schedule and out + arg (8 B per row and feature).
// The design is the shared max/min walk (minmax_walk.cuh) over the plan's
// schedule (MinMaxPlan.sched, derived once per plan): warps that own up to
// N edges of a row in groups of lanes with float4 loads, a strict compare
// over edges in id order, the split rows alone through 64-bit keys.  The
// design this replaced (a warp per segment of <= 256 CSR edges, lanes over
// features, scalar __ldg of x[col, f] per edge and feature: 0.2115 ms at
// K = 32 on density-rep and 3.2597 / 3.5189 ms at K = 602 on reddit-sim /
// density-rep, NVIDIA H100 80GB HBM3 at 700 W) is gone.
//
// The decoder: a ref is a CSR position; the id is the position, and a split
// row's winner is recomputed from its id as val[e] * x[col[e], f], the
// winner's own product.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minmax_walk.cuh"

namespace {

struct CsrEdges {
  const int* col;
  const float* val;

  __device__ __forceinline__ void edge(int ref, int& c, float& v,
                                       int& id) const {
    c = __ldg(col + ref);
    v = __ldg(val + ref);
    id = ref;
  }
  // sgn * (sgn*v * x) is v * x bit for bit, the sign of a zero included
  __device__ __forceinline__ float final(float best, float sgn) const {
    return sgn * best;
  }
  __device__ __forceinline__ float from_key(unsigned long long key, int f,
                                            const float* x, int ldx,
                                            float) const {
    const int e = minmax_key_id(key);
    return __fmul_rn(val[e], x[static_cast<size_t>(col[e]) * ldx + f]);
  }
};

}  // namespace

// out (num_rows, k) fp32 and arg (num_rows, k) int32 = max (negate = 0) or
// min (negate = 1) SpMM of the CSR (col, val) walked by the schedule in
// `args` (mmwalk::Args: x with row pitch ldx, the outputs, a scratch of
// (nsplit, k) uint64 that the walk zeroes itself), on CUDA device `device`
// and stream `stream`.  Returns the CUDA error of the launches (0 =
// launched).
extern "C" int spmm_minmax_launch(const void* col, const void* val,
                                  const mmwalk::Args* args, int device,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CsrEdges dec{static_cast<const int*>(col),
                     static_cast<const float*>(val)};
  return mmwalk::run(dec, *args, static_cast<cudaStream_t>(stream));
}
