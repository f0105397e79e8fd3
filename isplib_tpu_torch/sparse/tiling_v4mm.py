"""Hopper max/min SpMM plan: a work list over the graph's own CSR.

Counterpart of ``isplib_tpu.sparse.tiling_v4mm`` (``MinMaxTrainPlan``,
``build_minmax_stripes``), laid out for ``kernels/csrc/spmm_minmax_v4.cu``
rather than for the TPU.  The same work list drives the SDDMM and FusedMM
kernels (``sddmm.cu``, ``fused.cu``, ``fused_bwd.cu``); built over the CSC
it walks the rows of Aᵀ.  The kernel reads the graph's ``col`` and ``value``
directly, and an edge's CSR position is its edge id (the id the reference's
``spmm_arg_raw`` returns), so the plan holds no copy of the edges.  The JAX
plan's class depths, trains, lane groups, segment bitmasks, scatter sources,
column stripes and deferred packing served the TPU's vector unit, VMEM and
DMA batching; none of them bounds a Hopper kernel.

What it holds:

* a work list that cuts every row into segments of at most ``SEG_EDGES``
  edges (``seg_ptr`` (nseg + 1,) CSR positions, ``seg_row`` (nseg,)), so a
  hub row of 10⁴ edges spreads over many warps; an empty row gets one empty
  segment, so the kernel writes its 0 / sentinel like any other row;
* ``split_rows`` (nsplit,): the rows cut into more than one segment, whose
  partial winners the kernel combines with 64-bit atomics, and
  ``seg_slot`` (nseg,): the segment's row's index in ``split_rows``, or -1
  for a row that is one segment and is written directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .tiling_v5 import SEG_EDGES

__all__ = ["MinMaxPlan", "build_minmax_plan"]


@dataclasses.dataclass(frozen=True)
class MinMaxPlan:
    """Segment work list of a max/min SpMM over a row-sorted CSR."""

    seg_ptr: torch.Tensor      # (nseg + 1,) int32, CSR positions
    seg_row: torch.Tensor      # (nseg,) int32
    seg_slot: torch.Tensor     # (nseg,) int32, -1 = the row is one segment
    split_rows: torch.Tensor   # (nsplit,) int32
    num_rows: int
    num_cols: int
    nnz: int

    @property
    def nseg(self) -> int:
        return int(self.seg_row.shape[0])

    @property
    def nsplit(self) -> int:
        return int(self.split_rows.shape[0])

    def edge_rows(self) -> torch.Tensor:
        """The row of each of the ``nnz`` edges, int64 (the plain
        versions' COO view of the list)."""
        return torch.repeat_interleave(self.seg_row.long(),
                                       self.seg_ptr.diff().long())


def build_minmax_plan(rowptr: np.ndarray, num_rows: int, num_cols: int,
                      device: torch.device) -> MinMaxPlan:
    """Build the plan from the CSR row pointers (``rowptr[-1]`` = nnz)."""
    rowptr = np.asarray(rowptr, np.int64)
    lens = np.diff(rowptr)
    nseg_of_row = np.maximum(-(-lens // SEG_EDGES), 1)
    seg_row = np.repeat(np.arange(num_rows), nseg_of_row)
    first = np.repeat(np.cumsum(nseg_of_row) - nseg_of_row, nseg_of_row)
    seg_start = rowptr[seg_row] + (np.arange(seg_row.shape[0])
                                   - first) * SEG_EDGES
    nnz = int(rowptr[-1])
    split_rows = np.flatnonzero(nseg_of_row > 1)
    slot_of_row = np.full(num_rows, -1, np.int64)
    slot_of_row[split_rows] = np.arange(split_rows.shape[0])

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return MinMaxPlan(
        seg_ptr=i32(np.append(seg_start, nnz)), seg_row=i32(seg_row),
        seg_slot=i32(slot_of_row[seg_row]), split_rows=i32(split_rows),
        num_rows=num_rows, num_cols=num_cols, nnz=nnz)
