"""Hopper hybrid SpMM plan: dense 128×128 blocks plus a residual CSR.

Counterpart of ``isplib_tpu.sparse.tiling_v5.build_plan_v5_arrays`` (and the
residual half of ``tiling_v4``).  The dense/residual split is the JAX
package's, edge for edge: a 128×128 block of the adjacency with at least
``dense_threshold`` edges goes to the dense half, except that when more
blocks qualify than ``MAX_BLOCK_BYTES`` of bf16 blocks can hold, the
threshold rises to the smallest count that fits.  Every other edge goes to
the residual half.

The layout is chosen for the two CUDA kernels that consume it, not for the
TPU.  Column stripes, gather windows, lane groups and DMA-group padding
existed for the TPU's scalar-prefetch cap, VMEM budget and Mosaic loop
costs; none of them bounds a Hopper kernel, so they are gone:

* dense half (``kernels/spmm_bsr``): ``blocks`` (nb, 128, 128) bf16, each
  ``blocks[j, r, c] = A[br*128 + r, bc*128 + c]`` with duplicate edges summed
  in fp32 and then rounded to bf16 (as ``_densify_host`` of the JAX package
  does), sorted by block-row; ``blk_rowptr`` (n_br + 1,) and ``blk_col``
  (nb,) int32;
* residual half (``kernels/spmm_stream``): the row-sorted CSR ``res_rowptr``
  (R + 1,), ``res_col`` (nr,) int32 and ``res_val`` (nr,) float32, plus a
  work list that cuts every row into segments of at most ``SEG_EDGES``
  edges (``seg_ptr`` (nseg + 1,), ``seg_row`` (nseg,) int32), so a hub row
  of 10⁴ edges spreads over many warps.

Pad edges are never part of a plan: no kernel reads x row ``num_cols``.

Beside those arrays, and never in place of them, a plan with dense blocks
carries the schedule that K2 walks (``sched``, a ``BSRSchedule`` as K9's),
derived once per plan on the plan's device: every block as a member, the
block-rows cut into pieces of at most ``PIECE_BLOCKS`` blocks, so that one
CTA owns a block-row (or a piece of a hub block-row) and stores its output
once.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import native
from .tiling_v3 import MAX_PIECE, BSRSchedule, cut_pieces

__all__ = ["HybridPlan", "build_hybrid_plan", "derive_block_schedule", "BS",
           "SEG_EDGES", "PIECE_BLOCKS"]

BS = 128          # dense block edge
SEG_EDGES = 256   # residual edges per warp work item
MAX_BLOCK_BYTES = 2 << 30  # device bytes the dense half's blocks may take
PIECE_BLOCKS = 16  # blocks a K2 CTA takes at most (probe_bsr_v3.py)

_log = logging.getLogger(__name__)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Dense-block half plus residual-edge half of one SpMM direction."""

    blocks: torch.Tensor       # (nb, 128, 128) bf16
    blk_rowptr: torch.Tensor   # (n_br + 1,) int32
    blk_col: torch.Tensor      # (nb,) int32
    res_rowptr: torch.Tensor   # (num_rows + 1,) int32
    res_col: torch.Tensor      # (nr,) int32
    res_val: torch.Tensor      # (nr,) float32
    seg_ptr: torch.Tensor      # (nseg + 1,) int32
    seg_row: torch.Tensor      # (nseg,) int32
    num_rows: int
    num_cols: int
    dense_edges: int
    sparse_edges: int
    dense_threshold: int       # the threshold applied after the block cap
    sched: Optional[BSRSchedule] = None  # K2's walk (None without blocks)

    @property
    def nb(self) -> int:
        return int(self.blk_col.shape[0])

    @property
    def n_br(self) -> int:
        return _cdiv(self.num_rows, BS)

    @property
    def nseg(self) -> int:
        return int(self.seg_row.shape[0])

    @property
    def fill(self) -> float:
        """Real edges over the slots the plan stores: dense-block entries
        plus residual edges."""
        return (self.dense_edges + self.sparse_edges) / max(
            self.nb * BS * BS + self.sparse_edges, 1)


def derive_block_schedule(plan: HybridPlan,
                          piece_blocks: int = PIECE_BLOCKS) -> BSRSchedule:
    """K2's schedule of ``plan``, from ``blk_rowptr`` and ``blk_col``, on
    the plan's device.  The blocks are sorted by block-row already, so
    member ``j`` is block ``j`` (with its block column) and block-row
    ``br``'s members are ``blk_rowptr[br]:blk_rowptr[br + 1]``; pieces and
    zeroed block-rows as in K9's schedule.  K2 keeps a piece's list in
    shared memory, so a piece holds at most ``MAX_PIECE`` blocks."""
    if not 1 <= piece_blocks <= MAX_PIECE:
        raise ValueError(f"piece_blocks={piece_blocks}: K2 takes pieces of "
                         f"1 to {MAX_PIECE} blocks")
    dev = plan.blk_col.device
    members = torch.stack([torch.arange(plan.nb, device=dev),
                           plan.blk_col.long()], 1)
    pieces, zero_rbs = cut_pieces(plan.blk_rowptr.diff().long(),
                                  piece_blocks)
    return BSRSchedule(members=members.to(torch.int32).contiguous(),
                       pieces=pieces, zero_rbs=zero_rbs)


def build_hybrid_plan(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    num_rows: int,
    num_cols: int,
    device: torch.device,
    dense_threshold: int = 64,
) -> HybridPlan:
    """Build the plan from the real (unpadded) edges in CSR (row-sorted)
    order; the residual half keeps that order, so it needs no sort.

    The block counts and the dense fill are the port's native build
    (``native.bsr_count``; ``native.bsr_fill`` with one block a group, each
    block transposed back), or the numpy build, the reference, where
    ``native.available`` is patched to False.  Both sum a block's duplicate
    edges in float32 and give the same arrays bit for bit on the host, where
    ``index_add_`` sums in edge order too; on a card the numpy build's
    ``index_add_`` sums duplicates in the order its atomics land.
    """
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    nnz = int(row.shape[0])
    if nnz and not bool(np.all(row[1:] >= row[:-1])):
        raise ValueError("build_hybrid_plan needs row-sorted edges")
    n_br = _cdiv(num_rows, BS)
    n_bc = _cdiv(num_cols, BS)

    use_native = nnz > 0 and native.available()
    if use_native:
        counts = native.bsr_count(row, col, BS, n_br, n_bc)
    else:
        bid = (row // BS) * n_bc + (col // BS)
        counts = np.bincount(bid, minlength=n_br * n_bc)
    thr = max(dense_threshold, 1)
    nb_cap = max(1, MAX_BLOCK_BYTES // (BS * BS * 2))
    if int(np.count_nonzero(counts >= thr)) > nb_cap:
        # the smallest threshold whose block count fits the byte budget
        thr = int(np.sort(counts[counts >= thr])[::-1][nb_cap]) + 1
    dense_b = counts >= thr

    # ---- dense half: blocks sorted by (block-row, block-col) -------------
    dense_ids = np.flatnonzero(dense_b)
    nb = int(dense_ids.shape[0])
    slot = np.full(n_br * n_bc, -1, np.int64)
    slot[dense_ids] = np.arange(nb)
    blk_rowptr = np.zeros(n_br + 1, np.int64)
    np.cumsum(np.bincount(dense_ids // n_bc, minlength=n_br),
              out=blk_rowptr[1:])
    if use_native:
        # bsr_fill writes each block as blocks_t[j, c, r] = A[r, c]
        blocks_t, is_dense = native.bsr_fill(row, col, val, BS, n_br, n_bc,
                                             1, slot, nb)
        blocks = torch.from_numpy(blocks_t.view(np.int16)).to(device).view(
            torch.bfloat16).transpose(1, 2).contiguous()
        del blocks_t
        r_row, r_col, r_val = native.compact_residual(row, col, val,
                                                      is_dense)
    else:
        is_dense = dense_b[bid]
        d_row, d_col = row[is_dense], col[is_dense]
        flat = (slot[bid[is_dense]] * (BS * BS) + (d_row % BS) * BS
                + d_col % BS)
        blocks = torch.zeros(nb * BS * BS, dtype=torch.float32,
                             device=device)
        blocks.index_add_(0, torch.from_numpy(flat).to(device),
                          torch.from_numpy(val[is_dense]).to(device))
        blocks = blocks.to(torch.bfloat16).view(nb, BS, BS)
        r_row, r_col, r_val = row[~is_dense], col[~is_dense], val[~is_dense]

    # ---- residual half: row-sorted CSR and its segment work list ---------
    nr = int(r_row.shape[0])
    res_rowptr = np.zeros(num_rows + 1, np.int64)
    lens = np.bincount(r_row, minlength=num_rows)
    np.cumsum(lens, out=res_rowptr[1:])
    nseg_of_row = -(-lens // SEG_EDGES)
    seg_row = np.repeat(np.arange(num_rows), nseg_of_row)
    first = np.repeat(np.cumsum(nseg_of_row) - nseg_of_row, nseg_of_row)
    seg_start = res_rowptr[seg_row] + (np.arange(seg_row.shape[0])
                                       - first) * SEG_EDGES
    seg_ptr = np.append(seg_start, nr)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    plan = HybridPlan(
        blocks=blocks, blk_rowptr=i32(blk_rowptr),
        blk_col=i32(dense_ids % n_bc),
        res_rowptr=i32(res_rowptr), res_col=i32(r_col),
        res_val=torch.from_numpy(np.ascontiguousarray(r_val)).to(device),
        seg_ptr=i32(seg_ptr), seg_row=i32(seg_row),
        num_rows=num_rows, num_cols=num_cols,
        dense_edges=nnz - nr, sparse_edges=nr, dense_threshold=thr)
    if nb == 0:
        return plan
    t0 = time.perf_counter()
    plan = dataclasses.replace(plan, sched=derive_block_schedule(plan))
    s = plan.sched
    _log.info("v5 schedule: %d blocks over %d block-rows (at most %d in "
              "one) in %d pieces, %d block-rows zeroed first; derived in "
              "%.3fs", nb, n_br, int(plan.blk_rowptr.diff().max()),
              s.n_pieces, s.zero_rbs.shape[0], time.perf_counter() - t0)
    return plan
