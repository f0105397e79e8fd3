#!/usr/bin/env python3
"""Attribute the time of the max/min kernels on one CUDA card: where do K3
(``isplib_tpu_torch/kernels/csrc/spmm_minmax_v4.cu``) and K7
(``spmm_minmax.cu``), which share the walk of ``minmax_walk.cuh``, spend
it?

    python3 probe_minmax.py

Builds copies of both kernels with parts of the walk cut out or changed,
each with the port's nvcc flags into ``isplib_tpu_torch/_build/probe/``
(all at once, one nvcc a source).  Every copy also holds a staged mode
that the kernels do not have (``STAGED`` below, patched into the walk):
a CTA owns a piece of a 128-row block-row (at most P column blocks and E
edges), copies each column block's x tile (128 columns x 32 or 64
features) into shared memory with ``cp.async``, double-buffered, and its
warps take even shares of each block's edges, listed by (row, id); a
warp keeps the current row's winner in registers and combines it into the
block-row's 64-bit keys in shared memory at each row change.  The
variants:

* loads 8 / 16: vector loads a lane issues ahead, where the kernels issue
  4;
* staged KT 64: staged K tiles of 64 features above K = 32 (32 else);
* gather 8 floats: K tiles of 8 floats a lane (256 features) above K =
  128, where the kernels take 4 (128);
* scalar loads / float2 loads: x read as floats (or at most float2s),
  where the kernels take float4 or float2 as the row pitch allows (the
  staged tiles' copies too);
* no x reads: the walk's x loads and the staged mode's reads of its tiles
  replaced by values made from the column index;
* no tile copies: the staged mode's ``cp.async`` of its x tiles cut out;
* no row atomics: the staged mode's combine of a row's winner into the
  block-row's keys at each row change cut out (the last one stays);
* no edge words: each edge's column, value and id made from its place in
  the list, not read (the staged rows are still read);
* no compares: the staged mode's tie rule replaced by a plain max;
* L2 gather pass: the walk with its compares replaced by adds: the rate
  at which this card gathers x rows from L2, the walk's yardstick;

and times the kernel over its plan's schedule with the walk's variants,
the staged variants over a schedule that stages every block-row
(``derive_staged``), then the kernel over other schedules: staged pieces
of at most 2,000 to 128,000 edges or 1 to 1,000 blocks, items of 64 to
512 edges, and at K = 41 x unpadded (float loads) against the kernels'
copy padded to a row pitch of 44 (float4 loads), in both modes.  Cases:
K3 over ``chip_smoke.py``'s two graphs (reddit-sim, density-rep) and K7
over reddit-sim's shard 0 local and halo plans (4 shards), at K = 32, 41
and 602; max.  A variant that cuts work out computes garbage: only the
values and args of the kernel and of the kernel over another schedule
are compared with the plain version (bit for bit), and the count of
differing entries is printed for every line.  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "isplib_tpu_torch", "kernels", "csrc")
BLOCK = 128           # rows of a block-row, columns of a column block
TARGET_PIECES = 264   # staged pieces the default piece size aims at, two a
                      # streaming multiprocessor of an H100

# The staged mode, inserted at the end of namespace mmwalk in every copy of
# minmax_walk.cuh: its schedule (Staged), the kernel, and run_staged (the
# walk's pre-pass, the staged kernel, the walk's decode of split rows).
STAGED = r"""
constexpr int BLOCK = 128;
constexpr int STAGED_MAX_NK = 1;  // staged K tiles of 32 features

struct Staged {
  const int* stage_ref;  // refs, by (block, row, id)
  const int* stage_row;  // their rows within the block-row
  const int* blk_ptr;    // (nblk + 1,): each block's edges
  const int* blk_col;    // (nblk,): the block's column block
  const int* piece_ptr;  // (npiece + 1,): each piece's blocks
  const int* piece_br;   // (npiece,): the piece's block-row
  int npiece;
};

// V-float copy; src_bytes = 0 zero-fills the destination without reading
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

// x_s[c * KT + n] = x[c0 + c, k0 + n], zero outside x; one commit group
template <int KT, int V>
__device__ __forceinline__ void load_tile(float* x_s, const Args& a, int c0,
                                          int k0) {
  for (int q = threadIdx.x * V; q < BLOCK * KT; q += THREADS * V) {
    const int c = q / KT, n = q % KT;
    const bool ok = c0 + c < a.num_cols && k0 + n < a.ldx;
    cp_async<V>(x_s + q,
                ok ? a.x + static_cast<size_t>(c0 + c) * a.ldx + k0 + n
                   : a.x,
                ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <class D, int NK, int V>
__global__ void __launch_bounds__(THREADS) staged_kernel(const D dec, Args a,
                                                         Staged sg) {
  constexpr int KT = 32 * NK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);  // two BLOCK x KT tiles
  u64* keys = reinterpret_cast<u64*>(x_s + 2 * BLOCK * KT);  // BLOCK x KT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int piece = blockIdx.x, k0 = blockIdx.y * KT;
  const int b0 = sg.piece_ptr[piece], b1 = sg.piece_ptr[piece + 1];
  const int br = sg.piece_br[piece];
  const float sgn = a.negate ? -1.f : 1.f;

  for (int i = threadIdx.x; i < BLOCK * KT; i += THREADS) keys[i] = 0ull;
  load_tile<KT, V>(x_s, a, sg.blk_col[b0] * BLOCK, k0);

  for (int b = b0; b < b1; ++b) {
    const float* xt = x_s + ((b - b0) & 1) * BLOCK * KT;
    if (b + 1 < b1) {
      load_tile<KT, V>(x_s + ((b + 1 - b0) & 1) * BLOCK * KT, a,
                       sg.blk_col[b + 1] * BLOCK, k0);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // the tile has landed (and the keys are zeroed)

    // the warp's even share of the block's edges, by (row, ref)
    const int c0 = sg.blk_col[b] * BLOCK;
    const int lo = sg.blk_ptr[b], n = sg.blk_ptr[b + 1] - lo;
    const int q0 = lo + static_cast<int>(static_cast<long long>(n) * warp /
                                         WARPS);
    const int q1 = lo + static_cast<int>(static_cast<long long>(n) *
                                         (warp + 1) / WARPS);
    // this lane's edge of the batch at q (fetched a batch ahead)
    auto fetch = [&](int q, int& c, float& v, int& e, int& rl) {
      c = 0, v = 0.f, e = NO_ID, rl = 0;
      if (q + lane < q1) {
        dec.edge(__ldg(sg.stage_ref + q + lane), c, v, e);
        v *= sgn;
        c -= c0;
        rl = __ldg(sg.stage_row + q + lane);
      }
    };
    int row = -1;
    float best[NK];
    int id[NK];
    int c, e, rl;
    float v;
    fetch(q0, c, v, e, rl);
    for (int qb = q0; qb < q1; qb += 32) {
      int cn, en, rn;
      float vn;
      fetch(qb + 32, cn, vn, en, rn);
      const int m = min(32, q1 - qb);
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const int rj = __shfl_sync(FULL, rl, j);
        const int cj = __shfl_sync(FULL, c, j);
        const float vj = __shfl_sync(FULL, v, j);
        const int ej = __shfl_sync(FULL, e, j);
        if (rj != row) {  // uniform: the row's winner meets the others'
#pragma unroll
          for (int t = 0; t < NK; ++t) {
            if (row >= 0 && id[t] != NO_ID)
              atomicMax(keys + row * KT + lane + 32 * t,
                        minmax_key(best[t], id[t]));
            best[t] = -INFINITY;
            id[t] = NO_ID;
          }
          row = rj;
        }
#pragma unroll
        for (int t = 0; t < NK; ++t) {
          const float w = __fmul_rn(vj, xt[cj * KT + lane + 32 * t]);
          if (beats(w, best[t], id[t])) {
            best[t] = w;
            id[t] = ej;
          }
        }
      }
      c = cn, v = vn, e = en, rl = rn;
    }
    if (row >= 0)
#pragma unroll
      for (int t = 0; t < NK; ++t)
        if (id[t] != NO_ID)
          atomicMax(keys + row * KT + lane + 32 * t,
                    minmax_key(best[t], id[t]));
    __syncthreads();  // the tile is free for the load after next
  }

  for (int i = threadIdx.x; i < BLOCK * KT; i += THREADS) {
    const int r = br * BLOCK + i / KT, f = k0 + i % KT;
    const u64 key = keys[i];
    if (r >= a.num_rows || f >= a.k) continue;
    const int slot = a.row_slot[r];
    if (slot < 0) {  // a row without edges (or candidates): 0, sentinel
      const size_t o = static_cast<size_t>(r) * a.k + f;
      a.out[o] = key ? dec.from_key(key, f, a.x, a.ldx, sgn) : 0.f;
      a.arg[o] = key ? minmax_key_id(key) : a.sentinel;
    } else if (key) {
      atomicMax(a.scratch + static_cast<size_t>(slot) * a.k + f, key);
    }
  }
}

template <class D, int NK, int V>
cudaError_t launch_staged(const D& dec, const Args& a, const Staged& sg,
                          cudaStream_t st) {
  constexpr int KT = 32 * NK;
  // two x tiles and the block-row's keys
  constexpr size_t smem =
      static_cast<size_t>(BLOCK) * KT * (2 * sizeof(float) + sizeof(u64));
  cudaError_t err = cudaFuncSetAttribute(
      staged_kernel<D, NK, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(sg.npiece, (a.k + KT - 1) / KT);
  staged_kernel<D, NK, V><<<grid, THREADS, smem, st>>>(dec, a, sg);
  return cudaGetLastError();
}

template <class D, int V>
cudaError_t staged(const D& dec, const Args& a, const Staged& sg,
                   cudaStream_t st) {
  if (a.k > 32 && STAGED_MAX_NK >= 2)
    return launch_staged<D, 2, V>(dec, a, sg, st);
  return launch_staged<D, 1, V>(dec, a, sg, st);
}

template <class D>
int run_staged(const D& dec, const Args& a, const Staged& sg,
               cudaStream_t st) {
  if (a.k <= 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.x);
  const size_t n = static_cast<size_t>(a.nzero > a.nsplit ? a.nzero
                                                           : a.nsplit) * a.k;
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    size_t blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    prep_kernel<<<static_cast<int>(blocks), THREADS, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (sg.npiece > 0) {
    if (a.ldx % 4 == 0 && p % 16 == 0)
      err = staged<D, 4>(dec, a, sg, st);
    else if (a.ldx % 2 == 0 && p % 8 == 0)
      err = staged<D, 2>(dec, a, sg, st);
    else
      err = staged<D, 1>(dec, a, sg, st);
  }
  if (err != cudaSuccess || a.nsplit == 0) return static_cast<int>(err);
  const size_t nd = static_cast<size_t>(a.nsplit) * a.k;
  decode_kernel<D><<<static_cast<unsigned>((nd + THREADS - 1) / THREADS),
                     THREADS, 0, st>>>(dec, a);
  return static_cast<int>(cudaGetLastError());
}

"""
_NAMESPACE_END = "}  // namespace mmwalk"
# the staged entry point appended to each kernel's source: its launch's
# arguments with the Staged schedule after Args
ENTRIES = {
    "K3": ("spmm_minmax_v4.cu", r"""
extern "C" int spmm_minmax_staged_launch(const void* col, const void* val,
                                         const mmwalk::Args* args,
                                         const mmwalk::Staged* sg,
                                         int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CsrEdges dec{static_cast<const int*>(col),
                     static_cast<const float*>(val)};
  return mmwalk::run_staged(dec, *args, *sg,
                            static_cast<cudaStream_t>(stream));
}
"""),
    "K7": ("spmm_minmax.cu", r"""
extern "C" int spmm_minmax_v2_staged_launch(const void* edges,
                                            const void* chunk_col, int eb,
                                            const mmwalk::Args* args,
                                            const mmwalk::Staged* sg,
                                            int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const V2Edges dec{static_cast<const int*>(edges),
                    static_cast<const int*>(chunk_col), eb};
  return mmwalk::run_staged(dec, *args, *sg,
                            static_cast<cudaStream_t>(stream));
}
"""),
}

_GATHER_LOAD = ("          if (ok[u] && f < a.k) xv[u][t] = "
                "load_vec<V>(xr + f);\n")
_GATHER_CMP = ("            if (beats(w, best[t][i], id[t][i])) {\n"
               "              best[t][i] = w;\n"
               "              id[t][i] = ej[u];\n"
               "            }\n")
_STAGED_READ = "xt[cj * KT + lane + 32 * t]"
_PITCH4 = "    if (a.ldx % 4 == 0 && p % 16 == 0)"
_PITCH2 = "    else if (a.ldx % 2 == 0 && p % 8 == 0)"
# (old, new) edits of minmax_walk.cuh with STAGED in it; each applies
# wherever its text stands
VARIANTS = {
    "kernel": [],
    "loads 8": [("constexpr int LOADS_IN_FLIGHT = 4;",
                 "constexpr int LOADS_IN_FLIGHT = 8;")],
    "loads 16": [("constexpr int LOADS_IN_FLIGHT = 4;",
                  "constexpr int LOADS_IN_FLIGHT = 16;")],
    "staged KT 64": [("constexpr int STAGED_MAX_NK = 1;",
                      "constexpr int STAGED_MAX_NK = 2;")],
    "gather 8 floats": [
        ("  if (a.k > 64) return launch_gather<D, V, 32, 4 / V>(dec, a, st);",
         "  if (a.k > 128) return launch_gather<D, V, 32, 8 / V>(dec, a, st);"
         "\n  if (a.k > 64) return launch_gather<D, V, 32, 4 / V>(dec, a, st);"
         )],
    "scalar loads": [(_PITCH4, "    if (false)"),
                     (_PITCH2, "    else if (false)")],
    "float2 loads": [(_PITCH4, "    if (false)")],
    "no x reads": [
        (_GATHER_LOAD,
         "          if (ok[u] && f < a.k)\n"
         "            for (int i = 0; i < V; ++i)\n"
         "              xv[u][t].f[i] = 1e-30f * (cj + f + i);\n"),
        (_STAGED_READ, "1e-30f * (cj + lane + t)")],
    "no tile copies": [("    cp_async<V>(x_s + q,", "    if (false) "
                                                   "cp_async<V>(x_s + q,")],
    "no row atomics": [(
        "            if (row >= 0 && id[t] != NO_ID)\n"
        "              atomicMax(keys + row * KT + lane + 32 * t,\n"
        "                        minmax_key(best[t], id[t]));\n", "")],
    "no edge words": [
        ("        dec.edge(__ldg(sg.stage_ref + q + lane), c, v, e);\n",
         "        c = c0 + ((q + lane) & 127), v = 1.f, e = q + lane;\n"),
        ("      dec.edge(a.order ? __ldg(a.order + b + lane) : b + lane, c, v, "
         "e);\n", "      c = (b + lane) % a.num_cols, v = 1.f, e = b + lane;\n")],
    "no compares": [
        ("          if (beats(w, best[t], id[t])) {\n"
         "            best[t] = w;\n"
         "            id[t] = ej;\n"
         "          }\n",
         "          best[t] = fmaxf(best[t], w), id[t] = ej;\n")],
    "L2 gather pass": [(_GATHER_CMP,
                        "            best[t][i] += xv[u][t].f[i];\n"
                        "            id[t][i] = ej[u];\n")],
}
# the variants timed on the plan's own schedule, and on one that stages
# every block-row (the L2 gather pass last: its time gives the rate)
GATHER_VARIANTS = ("kernel", "loads 8", "loads 16", "gather 8 floats",
                   "scalar loads", "float2 loads", "no x reads",
                   "no edge words", "L2 gather pass")
STAGED_VARIANTS = ("kernel", "staged KT 64", "scalar loads", "float2 loads",
                   "no x reads", "no tile copies", "no row atomics",
                   "no edge words", "no compares")


class StagedArgs(ctypes.Structure):
    """``mmwalk::Staged`` of ``STAGED``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "stage_ref", "stage_row", "blk_ptr", "blk_col", "piece_ptr",
        "piece_br")] + [("npiece", ctypes.c_int)])


class StagedWalk:
    """A schedule that stages every block-row: the walk's ``sched`` (no
    items; its split rows, rows without edges and K7's chunk columns) and
    the pieces (``StagedArgs``' tensors), from ``derive_staged``."""

    def __init__(self, sched, tensors, piece_blocks, piece_edges, edges):
        self.sched, self.tensors = sched, tensors
        self.npiece = int(tensors["piece_br"].shape[0])
        self.line = (f"{edges} edges staged in {self.npiece} pieces of <= "
                     f"{piece_blocks} blocks and {piece_edges} edges; "
                     f"{sched.nsplit} split rows")

    def args(self) -> StagedArgs:
        return StagedArgs(*(t.data_ptr() for t in self.tensors.values()),
                          self.npiece)


def derive_staged(ref, row, col, num_rows, num_cols, ids=None,
                  chunk_col=None, piece_blocks=None,
                  piece_edges=None) -> StagedWalk:
    """Every block-row of the real edges ``ref`` (ascending; rows ``row``,
    columns ``col``, ids ``ids``, None: the refs) staged: its non-empty
    column blocks in pieces of at most ``piece_blocks`` blocks (None: a
    whole block-row) and ``piece_edges`` edges (None: the edges over
    ``TARGET_PIECES``; a block of more edges alone), each block's edges by
    (row, id)."""
    from isplib_tpu_torch.sparse.minmax_sched import MinMaxSchedule

    def i32(t):
        return t.to(torch.int32).contiguous()

    if ids is not None:  # by id, and stably by (block, row) below
        o = torch.argsort(ids, stable=True)
        ref, row, col = ref[o], row[o], col[o]
    dev = ref.device
    nbr = -(-num_rows // BLOCK)
    ncb = max(-(-num_cols // BLOCK), 1)
    br = row // BLOCK
    blk = br * ncb + col // BLOCK
    rl = row - br * BLOCK
    o = torch.argsort(blk * BLOCK + rl, stable=True)
    stage_ref, stage_row = ref[o], rl[o]
    ublk, blk_len = torch.unique_consecutive(blk[o], return_counts=True)
    nblk = int(ublk.shape[0])
    blk_ptr = torch.cat([blk_len.new_zeros(1), torch.cumsum(blk_len, 0)])
    blk_br = ublk // ncb
    if piece_edges is None:
        piece_edges = max(1, -(-int(stage_ref.shape[0]) // TARGET_PIECES))
    if piece_blocks is None:
        piece_blocks = ncb
    first = torch.cat([torch.ones(min(nblk, 1), dtype=torch.bool,
                                  device=dev), blk_br[1:] != blk_br[:-1]])
    idx = torch.arange(nblk, device=dev)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    cum = torch.cumsum(blk_len, 0) - blk_len
    before = cum - cum[start]  # edges of the block-row ahead of the block
    new_piece = first.clone()
    new_piece[1:] |= ((before[1:] // piece_edges
                       != before[:-1] // piece_edges)
                      | ((idx - start)[1:] // piece_blocks
                         != (idx - start)[:-1] // piece_blocks))
    piece_first = torch.nonzero(new_piece).flatten()
    piece_ptr = torch.cat([piece_first, piece_first.new_full((1,), nblk)])
    piece_br = blk_br[piece_first]
    split_br = torch.bincount(piece_br, minlength=nbr) > 1
    has_edges = torch.bincount(row, minlength=num_rows) > 0
    rows = torch.arange(num_rows, device=dev)
    split_rows = torch.nonzero(split_br[rows // BLOCK] & has_edges).flatten()
    row_slot = torch.full((num_rows,), -1, dtype=torch.int64, device=dev)
    row_slot[split_rows] = torch.arange(split_rows.shape[0], device=dev)
    sched = MinMaxSchedule(
        order=None, items=torch.zeros(0, 3, dtype=torch.int32, device=dev),
        row_slot=i32(row_slot), split_rows=i32(split_rows),
        zero_rows=i32(torch.nonzero(~has_edges).flatten()), item_edges=0,
        chunk_col=chunk_col)
    tensors = dict(stage_ref=i32(stage_ref), stage_row=i32(stage_row),
                   blk_ptr=i32(blk_ptr), blk_col=i32(ublk % ncb),
                   piece_ptr=i32(piece_ptr), piece_br=i32(piece_br))
    return StagedWalk(sched, tensors, piece_blocks, piece_edges,
                      int(ref.shape[0]))


def build_variants(out_dir: str) -> dict:
    """(variant, "K3" | "K7") -> the loaded library, all built at once (one
    nvcc each), each variant in a directory of its own."""
    from isplib_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    texts = {}
    for name in ("minmax_walk.cuh", "minmax_key.cuh",
                 *(src for src, _ in ENTRIES.values())):
        with open(os.path.join(CSRC, name)) as f:
            texts[name] = f.read()
    walk = texts["minmax_walk.cuh"]
    if walk.count(_NAMESPACE_END) != 1:
        raise RuntimeError(f"minmax_walk.cuh: no single {_NAMESPACE_END!r}")
    texts["minmax_walk.cuh"] = walk.replace(_NAMESPACE_END,
                                            STAGED + _NAMESPACE_END)
    for src, entry in ENTRIES.values():
        texts[src] += entry
    procs = {}
    for i, (vname, edits) in enumerate(VARIANTS.items()):
        files = dict(texts)
        for old, new in edits:
            if old not in files["minmax_walk.cuh"]:
                raise RuntimeError(f"{vname}: minmax_walk.cuh no longer has "
                                   f"{old!r}")
            files["minmax_walk.cuh"] = files["minmax_walk.cuh"].replace(
                old, new)
        d = os.path.join(out_dir, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for fname, body in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(body)
        for kname, (src, _) in ENTRIES.items():
            lib = os.path.join(d, f"{kname}.so")
            procs[(vname, kname)] = (lib, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", lib, os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (vname, kname), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kname} {vname}:\n{log}")
        libs[(vname, kname)] = ctypes.CDLL(lib)
    print(f"built {len(libs)} libraries", flush=True)
    return libs


def launcher(lib, kname, plan, walk, col=None, val=None):
    """fn(x, raw=False) -> (out, arg): one call of a variant library, as
    the wrappers make it (max, an odd K padded), over ``walk`` (a
    ``MinMaxSchedule``, or a ``StagedWalk``: the staged entry point);
    ``raw`` passes x as it is."""
    from isplib_tpu_torch.kernels.minmax_walk import (Args, launch_args,
                                                      pitched)

    staged = isinstance(walk, StagedWalk)
    sched = walk.sched if staged else walk
    tail = [ctypes.POINTER(StagedArgs)] if staged else []
    if kname == "K3":
        fn = (lib.spmm_minmax_staged_launch if staged
              else lib.spmm_minmax_launch)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(Args), *tail, ctypes.c_int,
                       ctypes.c_void_p]
        head = (col.data_ptr(), val.data_ptr())
    else:
        fn = (lib.spmm_minmax_v2_staged_launch if staged
              else lib.spmm_minmax_v2_launch)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.POINTER(Args), *tail, ctypes.c_int,
                       ctypes.c_void_p]
        head = (plan.edges.data_ptr(), sched.chunk_col.data_ptr(), plan.eb)
    fn.restype = ctypes.c_int

    def run(x, raw=False):
        x = x if raw else pitched(x)
        k = x.shape[1]
        out = torch.empty(plan.num_rows, k, device=x.device)
        arg = torch.empty(plan.num_rows, k, dtype=torch.int32,
                          device=x.device)
        scratch = torch.empty(sched.nsplit, k, dtype=torch.int64,
                              device=x.device)
        args = launch_args(sched, x, out, arg, scratch, plan.num_rows,
                           plan.num_cols, k, False, 2**31 - 1)
        extra = [ctypes.byref(walk.args())] if staged else []
        err = fn(*head, ctypes.byref(args), *extra, x.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out, arg

    return run


def cases():
    """(label, kernel, plan, schedule, derive(**kw), stage(**kw), edges,
    plain(x), col, val) of every probed plan: ``derive`` the plan's
    schedule with other knobs, ``stage`` a ``StagedWalk`` of its edges."""
    from isplib_tpu_torch import graph_from_arrays
    from isplib_tpu_torch.data import gen_gcnsig_graph
    from isplib_tpu_torch.dist import partition_rows
    from isplib_tpu_torch.kernels import spmm_minmax, spmm_minmax_v4
    from isplib_tpu_torch.sparse.tiling_v2 import derive_v2_minmax_schedule
    from isplib_tpu_torch.sparse.tiling_v4mm import (build_minmax_plan,
                                                     derive_minmax_schedule)

    e = int(cs.E_REAL * cs.SCALE)
    occ = cs.E_REAL / (cs.N_REAL / 128.0) ** 2
    out = []
    for name, nodes, seed in (
            ("reddit-sim", int(cs.N_REAL * cs.SCALE), cs.SEED),
            ("density-rep", int(128 * np.sqrt(e / occ)), cs.SEED + 7)):
        arrays = gen_gcnsig_graph(nodes, e, cs.CLASSES, cs.FEATURES, seed,
                                  cs.EDGE_MULTIPLE)
        g = graph_from_arrays(arrays, "cuda")
        n = g.nnz
        plan = build_minmax_plan(g.rowptr.cpu().numpy(), g.num_rows,
                                 g.num_cols, g.device, schedule=True)
        out.append((name, "K3", plan, plan.sched,
                    lambda plan=plan, **kw: derive_minmax_schedule(plan,
                                                                   **kw),
                    lambda plan=plan, g=g, n=n, **kw: derive_staged(
                        torch.arange(n, device=g.device),
                        plan.edge_rows().long(), g.col[:n].long(),
                        plan.num_rows, plan.num_cols, **kw), n,
                    lambda x, plan=plan, g=g: spmm_minmax_v4.
                    spmm_minmax_v4_plain(plan, g.col, g.value, x, "max",
                                         2**31 - 1), g.col, g.value))
        if name != "reddit-sim":
            continue
        sg = partition_rows(arrays["row"][:n], arrays["col"][:n],
                            arrays["value"][:n], int(arrays["num_rows"]), 4,
                            tiling={"version": 2}, device="cuda", hold=[0])
        for label, p in zip(("shard 0 loc", "shard 0 halo"),
                            sg.shard(0).plans_mm):
            s = p.slots()
            flat = torch.nonzero(s["eid"] >= 0).flatten()

            def stage(p=p, s=s, flat=flat, **kw):
                return derive_staged(flat, s["row"][flat], s["col"][flat],
                                     p.num_rows, p.num_cols,
                                     ids=s["eid"][flat],
                                     chunk_col=p.mm_sched.chunk_col, **kw)

            out.append((f"reddit-sim {label}", "K7", p, p.mm_sched,
                        lambda p=p, **kw: derive_v2_minmax_schedule(p, **kw),
                        stage, int(flat.shape[0]),
                        lambda x, p=p: spmm_minmax.spmm_minmax_v2_plain(
                            p, x, "max", 2**31 - 1), None, None))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_minmax: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    print(cs.card_line(), flush=True)
    libs = build_variants(os.path.join(ROOT, "isplib_tpu_torch", "_build",
                                       "probe"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def differ(got, want):
        return int((got[0].view(torch.int32)
                    != want[0].view(torch.int32)).sum()
                   + (got[1] != want[1]).sum())

    def walk_line(s, edges):
        return s.line if isinstance(s, StagedWalk) else cs.walk_line(s, edges)

    for (label, kname, plan, sched, derive, stage, edges, plain, col,
         val) in cases():
        print(f"{kname} {label}: {walk_line(sched, edges)}", flush=True)
        staged_all = stage()
        scheds = {f"staged, <= {n} edges a piece": stage(piece_edges=n)
                  for n in (2000, 8000, 32000, 128000)}
        scheds.update({f"staged, <= {p} blocks a piece": stage(
            piece_blocks=p, piece_edges=2**30) for p in (1, 4, 16, 1000)})
        scheds.update({f"gather, items of {n}": derive(item_edges=n)
                       for n in (64, 128, 512)})
        for k in (32, 41, 602):
            x = torch.randn(plan.num_cols, k, device="cuda", generator=gen)
            want = plain(x)
            iters = 10 if k > 64 else 20

            def line(name, lib, s, raw=False):
                run = launcher(lib, kname, plan, s, col, val)
                got = run(x, raw)
                ms = cs.cuda_ms(lambda: run(x, raw), iters=iters)
                print(f"  {kname} {label:19s} K={k:<3d} {name:34s} "
                      f"{ms:.4f} ms; {differ(got, want)} entries differ "
                      f"({walk_line(s, edges)})", flush=True)
                return ms

            kernel = libs[("kernel", kname)]
            for vname in GATHER_VARIANTS:
                if vname != "gather 8 floats" or k > 128:
                    ms = line(f"gather: {vname}", libs[(vname, kname)],
                              sched)
            print(f"    the L2 gather pass moves {edges * k * 4 / 1e9:.3f} "
                  f"GB of x rows: {edges * k * 4 / ms / 1e9:.2f} TB/s",
                  flush=True)
            for vname in STAGED_VARIANTS:
                if vname != "staged KT 64" or k > 32:
                    line(f"staged: {vname}", libs[(vname, kname)],
                         staged_all)
            for sname, s in scheds.items():
                line(sname, kernel, s)
            if k == 41:
                for mode, s in (("gather", sched), ("staged", staged_all)):
                    line(f"{mode}: x unpadded (floats)", kernel, s,
                         raw=True)
            del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
