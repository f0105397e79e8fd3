// GAT's attention aggregation over the CSR and CSC segment lists
// (isplib_tpu_torch.kernels.gat_attention).
//
// Replaces no TPU kernel: the JAX package has no attention whose edge
// values need a gradient (its spmm over g.with_value(att) runs XLA).  Added
// for GATConv (Velickovic et al. 2018), whose softmax over each row's
// entries and whose weighted sum, for H heads of C features each, would
// otherwise be a handful of plain gathers and scatters over nnz x H logits
// and nnz x H*C messages.  For row r (its entries the real edges (r, c)
// with c != r, and one self loop (r, r) that the kernels add themselves):
//
//   z   = s_dst[r, h] + s_src[c, h],  e = LeakyReLU(z)
//   lse = log sum exp(e) over the row               (att_stats, two passes)
//   a   = exp(e - lse)
//   out[r, h] = sum a * x[c, h]                            (att_gather)
//   dx[c, h]  = sum over the column's entries a * g[r, h]  (att_gather, CSC)
//   dz = a (<g[r,h], x[c,h]> - <g[r,h], out[r,h]>) * LeakyReLU'(z)
//   ds_dst[r] += dz (att_bwd_e),  ds_src[c] += dz        (att_colsum, CSC)
//
// Every kernel walks a MinMaxPlan's segments (sparse/tiling_v4mm.py: each
// row cut into segments of at most SEG_EDGES = 256 entries, an empty row
// one empty segment), a warp a segment, so a hub row spreads over many
// warps; the row's first segment also takes the self loop.  A row cut
// into several segments (seg_slot >= 0) meets by atomics: the max by an
// ordered float compare-and-swap, the sums by atomicAdd into rows the
// wrapper zeroed: a hub row of 10^5 entries adds ~10^3 segment sums, not
// 10^5 terms one by one.  So att_bwd_e stores dz by CSR position and
// att_colsum sums it over the CSC's segments, rather than scattering
// every entry's dz into its column.  No a is stored: the backward
// recomputes it from the scores and lse, which cost 4*H bytes a row and
// sit in L2.
//
// What bounds it on an H100: the row gathers.  att_gather reads x[c] (4*K
// bytes) once an entry, att_bwd_e the same; at K = 1024 that is 4 KiB an
// entry, ~470 GB a pass over Reddit's 114.8M entries, far above the 4*(rows
// + cols)*K bytes the roofline counts (each row once), so they run at the
// gather rate of HBM and L2, not at the roofline.  Both read a row across
// the warp, consecutive lanes on consecutive float4 chunks, with several
// entries' loads in flight.  att_gather holds its output row in the lanes
// (chunks q = t*32 + lane of the row, head q / (C/4), a lane's T chunks in
// registers), computes each entry's H weights once, in the entry's own
// lane, into shared memory, and adds a * x[c] for 32 entries in turn with
// U entries' loads in flight.  att_bwd_e needs a dot an entry and head, so
// it gives each head LH lanes (the largest power of 2 with LH*H <= 32: 8 at
// 4 heads, 4 at 6), a lane chunks j, j + LH, ... of its head's C/4 (a head
// of 11 chunks takes 3 a lane on 4 lanes), holds g[r] in those registers,
// and sums each of 8 entries' products in a register.  A transposed
// reduction then sums the 8 over the head's lanes: at each of the lane
// bits 1, 2, 4 a lane keeps half its sums and sends the other half, so 8
// entries cost 4 + 2 + 1 = 7 shuffles at LH = 8 (0.9 an entry, where a
// warp sum an entry and head costs 5 * H = 20) and 4 + 2 = 6 at LH = 4,
// and every lane ends with whole sums of its head (one entry at LH >= 8,
// two at 4), whose a and dz it computes once.  Heads are padded to a
// multiple of 4 features by the wrapper, so a float4 chunk belongs to one
// head; K (padded) is at most 1024 and H at most 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gatt {

// Field for field the ctypes Structure of kernels/gat_attention.py.
struct Args {
  const int* seg_ptr;   // (nseg + 1,) positions in nbr
  const int* seg_row;   // (nseg,) the segment's row (a column for the CSC)
  const int* seg_slot;  // (nseg,) >= 0: the row is cut into several
  const int* nbr;       // col (CSR), csc_col or csc2csr (CSC), by position
  const float* x;       // (N, kp4 * 4): gathered rows, xw or g
  const float* g;       // (N, kp4 * 4): the cotangent of out (att_bwd_e)
  const float* y;       // (N, kp4 * 4): out (att_bwd_e)
  const float* ss;      // (N, H) s_src
  const float* sd;      // (N, H) s_dst
  const float* lse;     // (N, H)
  float* m;             // (N, H) row max, -inf filled (stats)
  float* l;             // (N, H) row sum, zeroed (stats)
  float* out;           // (N, kp4 * 4), split rows zeroed (att_gather)
  float* dss;           // (N, H), zeroed (att_bwd_e, att_colsum)
  float* dsd;           // (N, H), zeroed (att_bwd_e)
  float* dz;            // (nnz, H) dz by CSR position (att_bwd_e, att_colsum)
  int nseg, heads, kp4, cp4;
  float slope;
};

}  // namespace gatt

namespace {

using gatt::Args;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXH = 8;     // heads a launch takes at most
constexpr int MAXT = 8;     // float4 chunks a lane: K <= 32 * 4 * 8 = 1024
constexpr int MAXKP4 = 32 * MAXT;

__device__ __forceinline__ float leaky(float z, float s) {
  return z > 0.f ? z : z * s;
}

// max of a float in memory, for any signs (-inf filled): a non-negative
// float orders as an int, a negative one in reverse as an unsigned
__device__ __forceinline__ void atomic_max_float(float* p, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// The segment of this warp: its row, its entries [e0, e1) and whether it
// is the row's first (which adds the self loop as entry e0 - 1).
struct Seg {
  int r, e0, e1;
  bool first;
  __device__ Seg(const Args& a, int s) {
    r = a.seg_row[s];
    e0 = a.seg_ptr[s];
    e1 = a.seg_ptr[s + 1];
    first = s == 0 || a.seg_row[s - 1] != r;
  }
  __device__ int begin() const { return first ? e0 - 1 : e0; }
  // the entry's neighbour, or -1 for a self loop of the graph (the added
  // one replaces it)
  __device__ int nbr(const Args& a, int e) const {
    if (e < e0) return r;
    const int c = a.nbr[e];
    return c == r ? -1 : c;
  }
};

// Pass 1 (SUM false) the row max of e, pass 2 (SUM true) the row sum of
// exp(e - max); an entry a lane over the CSR segments.
template <bool SUM>
__global__ void __launch_bounds__(THREADS)
    att_stats_kernel(const __grid_constant__ Args a) {
  const int s = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (s >= a.nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31, H = a.heads;
  const Seg sg(a, s);
  float own[MAXH], mx[MAXH], acc[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    own[h] = h < H ? a.sd[sg.r * H + h] : 0.f;
    mx[h] = SUM && h < H ? a.m[sg.r * H + h] : 0.f;
    acc[h] = SUM ? 0.f : -INFINITY;
  }
  for (int e = sg.begin() + lane; e < sg.e1; e += 32) {
    const int c = sg.nbr(a, e);
    if (c < 0) continue;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h >= H) break;
      const float v = leaky(own[h] + a.ss[c * H + h], a.slope);
      acc[h] = SUM ? acc[h] + expf(v - mx[h]) : fmaxf(acc[h], v);
    }
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h >= H) break;
    const float v = SUM ? warp_sum(acc[h]) : warp_max(acc[h]);
    if (lane == 0) {
      if (SUM)
        atomicAdd(a.l + sg.r * H + h, v);
      else
        atomic_max_float(a.m + sg.r * H + h, v);
    }
  }
}

// out[r] = sum over the segment's entries of a * x[c], head by head; with
// TRANS the segments are the CSC's (r a column, c the entry's row), so a
// takes the neighbour's s_dst and lse and the segment's s_src.  T float4
// chunks a lane, U entries' loads in flight.
template <int T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
    att_gather_kernel(const __grid_constant__ Args a) {
  constexpr int U = T > 4 ? 2 : 4;
  __shared__ float s_w[WARPS][32 * MAXH];
  __shared__ int s_c[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= a.nseg) return;  // uniform across the warp; no block barrier
  const int H = a.heads;
  const Seg sg(a, s);
  float own_s[MAXH], own_l[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    own_s[h] = h < H ? (TRANS ? a.ss : a.sd)[sg.r * H + h] : 0.f;
    own_l[h] = !TRANS && h < H ? a.lse[sg.r * H + h] : 0.f;
  }
  int hh[T];
  float4 acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int q = t * 32 + lane;
    hh[t] = q < a.kp4 ? q / a.cp4 : 0;
    acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  float* w = s_w[warp];
  for (int b = sg.begin(); b < sg.e1; b += 32) {
    const int e = b + lane;
    const int c = e < sg.e1 ? sg.nbr(a, e) : -1;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h >= H) break;
      float al = 0.f;
      if (c >= 0) {
        const float z = TRANS ? a.sd[c * H + h] + own_s[h]
                              : own_s[h] + a.ss[c * H + h];
        const float lse = TRANS ? a.lse[c * H + h] : own_l[h];
        al = expf(leaky(z, a.slope) - lse);
      }
      w[lane * MAXH + h] = al;
    }
    // an entry without weight reads the segment's own row, which exists
    s_c[warp][lane] = c >= 0 ? c : sg.r;
    __syncwarp();
    const int n = min(32, sg.e1 - b);
    for (int k = 0; k < n; k += U) {
      float4 v[U][T];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ku = min(k + u, n - 1);
        const float4* xr = x4 + static_cast<size_t>(s_c[warp][ku]) * a.kp4;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int q = t * 32 + lane;
          v[u][t] = q < a.kp4 ? __ldg(xr + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= n) break;
#pragma unroll
        for (int t = 0; t < T; ++t)
          fma4(acc[t], w[(k + u) * MAXH + hh[t]], v[u][t]);
      }
    }
    __syncwarp();
  }
  float* o = a.out + static_cast<size_t>(sg.r) * a.kp4 * 4;
  const bool split = a.seg_slot[s] >= 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int q = t * 32 + lane;
    if (q >= a.kp4) continue;
    if (split) {
      atomicAdd(o + 4 * q, acc[t].x);
      atomicAdd(o + 4 * q + 1, acc[t].y);
      atomicAdd(o + 4 * q + 2, acc[t].z);
      atomicAdd(o + 4 * q + 3, acc[t].w);
    } else {
      reinterpret_cast<float4*>(o)[q] = acc[t];
    }
  }
}

// Sums v[0..7] (8 entries' partial dots) over the lh lanes of a head (lh a
// power of 2, the group aligned): at lane bits 1, 2 and 4 (those under lh)
// a lane keeps half its sums, entries base + i, and adds the other lane's
// half; bits 8 and 16 add the last sum whole.  Returns how many sums the
// lane holds (8 >> the bits halved); lanes j < 8 of the group hold each
// entry once.
__device__ __forceinline__ int reduce_entries(float (&v)[8], int lh, int j,
                                              int& base) {
  int m = 8;
  base = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int o = 1 << b, half = 4 >> b;
    if (o >= lh) break;  // uniform across the warp
    const bool up = (j >> b) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (up) base += half;
    m = half;
  }
  for (int o = 8; o < lh; o <<= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return m;
}

// Lanes a head in att_bwd_e: the largest power of 2 with lh * heads <= 32.
__host__ __device__ __forceinline__ int lanes_a_head(int heads) {
  int lh = 32;
  while (lh * heads > 32) lh >>= 1;
  return lh;
}

// Blocks an SM that att_bwd_e asks ptxas to fit, which caps its registers
// a thread: 64 up to 4 chunks a lane, 128 up to 8, 255 beyond.  Without a
// bound ptxas took 104 at 8 chunks and kept fewer of two entries' 16 loads
// in flight (H100, 4 x 256 on Reddit's 114.6M entries: 110 ms against 74
// at 128).  At 3 chunks 64 registers ran 18.4 ms; a bound of 2 blocks
// (128) ran 21.2 and of 1 ran 31.6, each with fewer blocks an SM.
constexpr int bwd_e_blocks(int t) { return t > 8 ? 1 : t > 4 ? 2 : 4; }

// dz of every entry of the CSR segments, its row sum into dsd and the
// added self loop's into dss by atomics.  Each entry's row x[c] is read by
// the whole warp, each head's C/4 chunks by its lh lanes (T a lane), with U
// entries' loads in flight; 8 entries' dots are summed over the head's
// lanes by reduce_entries.
template <int T>
__global__ void __launch_bounds__(THREADS, bwd_e_blocks(T))
    att_bwd_e_kernel(const __grid_constant__ Args a) {
  constexpr int E = 8;  // entries summed before reducing
  constexpr int U = T > 8 ? 1 : T > 4 ? 2 : T > 2 ? 4 : 8;
  __shared__ int s_c[WARPS][32];
  __shared__ float s_z[WARPS][32 * MAXH], s_a[WARPS][32 * MAXH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= a.nseg) return;  // uniform across the warp; no block barrier
  const int H = a.heads, cp4 = a.cp4, lh = lanes_a_head(H);
  const int hd = lane / lh, j = lane % lh;
  const bool act = hd < H;  // lanes past the last head idle
  const Seg sg(a, s);
  // the lane's chunks: off[t] from its first, its first again where the
  // head has no chunk t (g is 0 there), so no load of a row is predicated;
  // a lane without any chunk reads chunk 0
  const size_t row0 = act && j < cp4 ? static_cast<size_t>(hd) * cp4 + j : 0;
  int off[T];
#pragma unroll
  for (int t = 0; t < T; ++t) off[t] = act && j + lh * t < cp4 ? lh * t : -1;
  const float4* g4 = reinterpret_cast<const float4*>(a.g) +
                     static_cast<size_t>(sg.r) * a.kp4 + row0;
  const float4* y4 = reinterpret_cast<const float4*>(a.y) +
                     static_cast<size_t>(sg.r) * a.kp4 + row0;
  // the lane's chunks of g[r], and D = <g[r,h], out[r,h]> over the head
  float4 gr[T];
  float dd = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    gr[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off[t] >= 0) {
      gr[t] = g4[off[t]];
      dd += dot4(gr[t], y4[off[t]]);
    }
    off[t] = max(off[t], 0);
  }
  for (int o = 1; o < lh; o <<= 1) dd += __shfl_xor_sync(0xffffffffu, dd, o);
  float rsum = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(a.x) + row0;
  int* sc = s_c[warp];
  float* sz = s_z[warp];
  float* sa = s_a[warp];
  for (int b = sg.begin(); b < sg.e1; b += 32) {
    {  // the batch's neighbours (-1: a self loop of the graph's), z and a
      const int e = b + lane;
      const int c = e < sg.e1 ? sg.nbr(a, e) : -1;
      sc[lane] = c;
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h >= H) break;
        float z = 0.f, al = 0.f;
        if (c >= 0) {
          z = a.sd[sg.r * H + h] + a.ss[c * H + h];
          al = expf(leaky(z, a.slope) - a.lse[sg.r * H + h]);
        }
        sz[lane * MAXH + h] = z;
        sa[lane * MAXH + h] = al;
      }
    }
    __syncwarp();
    const int n = min(32, sg.e1 - b);
    for (int kb = 0; kb < n; kb += E) {
      float part[E];
#pragma unroll
      for (int i = 0; i < E; i += U) {
        float4 v[U][T];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = kb + i + u;
          // past the batch or a self loop of the graph's: the segment's
          // own row, whose dot no lane uses
          const int c = k < n ? sc[k] : -1;
          const float4* xr =
              x4 + static_cast<size_t>(c >= 0 ? c : sg.r) * a.kp4;
#pragma unroll
          for (int t = 0; t < T; ++t) v[u][t] = __ldg(xr + off[t]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int t = 0; t < T; ++t) d += dot4(gr[t], v[u][t]);
          part[i + u] = d;
        }
      }
      int base;
      const int m = reduce_entries(part, lh, j, base);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int k = kb + base + i;
        if (i >= m || !act || j >= E || k >= n) continue;
        const int e = b + k;
        if (sc[k] < 0) {  // a self loop of the graph's: no entry, dz 0
          a.dz[static_cast<size_t>(e) * H + hd] = 0.f;
          continue;
        }
        const float z = sz[k * MAXH + hd], al = sa[k * MAXH + hd];
        const float dz = al * (part[i] - dd) * (z > 0.f ? 1.f : a.slope);
        rsum += dz;
        if (e < sg.e0)  // the added self loop: its column is the row
          atomicAdd(a.dss + sg.r * H + hd, dz);
        else
          a.dz[static_cast<size_t>(e) * H + hd] = dz;
      }
    }
    __syncwarp();
  }
  for (int o = 1; o < lh; o <<= 1)
    rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
  if (act && j == 0) atomicAdd(a.dsd + sg.r * H + hd, rsum);
}

// ds_src += the column sums of dz over the CSC segments (an entry a lane,
// dz read at the entry's CSR position, nbr = csc2csr), so a hub column's
// sum is a tree within each segment and one atomicAdd a segment.
__global__ void __launch_bounds__(THREADS)
    att_colsum_kernel(const __grid_constant__ Args a) {
  const int s = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (s >= a.nseg) return;  // uniform across the warp
  const int lane = threadIdx.x & 31, H = a.heads;
  const int r = a.seg_row[s], e1 = a.seg_ptr[s + 1];
  float acc[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
  for (int e = a.seg_ptr[s] + lane; e < e1; e += 32) {
    const size_t at = static_cast<size_t>(a.nbr[e]) * H;
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < H) acc[h] += a.dz[at + h];
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h >= H) break;
    const float v = warp_sum(acc[h]);
    if (lane == 0) atomicAdd(a.dss + r * H + h, v);
  }
}

int check(const Args& a) {
  if (a.heads < 1 || a.heads > MAXH || a.kp4 < 1 || a.kp4 > MAXKP4 ||
      a.cp4 < 1 || a.cp4 * a.heads != a.kp4)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int blocks(const Args& a) { return (a.nseg + WARPS - 1) / WARPS; }

template <int T>
int gather(const Args& a, bool trans, cudaStream_t s) {
  if (trans)
    att_gather_kernel<T, true><<<blocks(a), THREADS, 0, s>>>(a);
  else
    att_gather_kernel<T, false><<<blocks(a), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int bwd_e(const Args& a, cudaStream_t s) {
  att_bwd_e_kernel<T><<<blocks(a), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// a head's chunks a lane in att_bwd_e
int bwd_e_chunks(const Args& a) {
  const int lh = lanes_a_head(a.heads);
  return (a.cp4 + lh - 1) / lh;
}

int chunks_a_lane(const Args& a) { return (a.kp4 + 31) / 32; }

}  // namespace

// The two passes of the row statistics over the CSR segments: pass 0 the
// max into m (filled with -inf by the caller), pass 1 the sum of exp(e -
// m) into l (zeroed).  Each launcher returns the CUDA error of its launch.
extern "C" int att_stats_launch(const gatt::Args* a, int pass,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (const int bad = check(*a)) return bad;
  if (a->nseg == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0)
    att_stats_kernel<false><<<blocks(*a), THREADS, 0, s>>>(*a);
  else
    att_stats_kernel<true><<<blocks(*a), THREADS, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// out = the weighted sum over the segments (trans 0: the CSR's, x = xw;
// trans 1: the CSC's, x = g, out = dx); out's split rows zeroed.
extern "C" int att_gather_launch(const gatt::Args* a, int trans,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (const int bad = check(*a)) return bad;
  if (a->nseg == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunks_a_lane(*a)) {
    case 1: return gather<1>(*a, trans != 0, s);
    case 2: return gather<2>(*a, trans != 0, s);
    case 3: return gather<3>(*a, trans != 0, s);
    case 4: return gather<4>(*a, trans != 0, s);
    case 5: return gather<5>(*a, trans != 0, s);
    case 6: return gather<6>(*a, trans != 0, s);
    case 7: return gather<7>(*a, trans != 0, s);
    default: return gather<8>(*a, trans != 0, s);
  }
}

// dsd (zeroed) and dz, by CSR position, from g, out (y), xw (x), the
// scores and lse over the CSR segments; the added self loops' dz into dss
// (zeroed).
extern "C" int att_bwd_e_launch(const gatt::Args* a, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (const int bad = check(*a)) return bad;
  if (a->nseg == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bwd_e_chunks(*a)) {
    case 1: return bwd_e<1>(*a, s);
    case 2: return bwd_e<2>(*a, s);
    case 3: return bwd_e<3>(*a, s);
    case 4: return bwd_e<4>(*a, s);
    case 5: return bwd_e<5>(*a, s);
    case 6: return bwd_e<6>(*a, s);
    case 7: return bwd_e<7>(*a, s);
    case 8: return bwd_e<8>(*a, s);
    case 9: case 10: case 11: case 12: return bwd_e<12>(*a, s);
    default: return bwd_e<16>(*a, s);
  }
}

// dss += the column sums of dz over the CSC segments (nbr = csc2csr).
extern "C" int att_colsum_launch(const gatt::Args* a, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (const int bad = check(*a)) return bad;
  if (a->nseg == 0) return 0;
  att_colsum_kernel<<<blocks(*a), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
