"""The schedule of the max/min walk (``kernels/csrc/minmax_walk.cuh``) that
K3 (``kernels/spmm_minmax_v4``, over a ``MinMaxPlan``) and K7
(``kernels/spmm_minmax``, over a with-eids ``TiledPlanV2``) share.

It is derived once per plan, beside the plan's JAX-equal arrays and never
in their place, from each real edge's *ref* (what the kernel's edge
decoder reads: K3's CSR position, K7's flat slot index ``chunk·eb +
slot``) and global row.  The kernels read the edges' columns, values and
ids through the refs at call time, so nothing of the edges is baked in.
Each row's edges, by (row, id), are cut into work items of at most
``item_edges`` (``items`` (nseg, 3): the range in ``order`` and the row;
K3's ``order`` is None, its items being ranges of CSR positions).  A row
whose edges are cut over several items (*split*) meets in a scratch of
only those rows (``split_rows``; ``row_slot`` (num_rows,), the row's
scratch row or −1); ``zero_rows`` are the rows without edges.  All int32,
on the plan's device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

__all__ = ["MinMaxSchedule", "derive_walk", "ITEM_EDGES"]

ITEM_EDGES = 256      # edges a warp takes at most (probe_minmax.py)

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MinMaxSchedule:
    """The max/min walk of one plan (module docstring)."""

    order: Optional[torch.Tensor]  # (n_edges,) refs, or None (K3)
    items: torch.Tensor            # (nseg, 3) lo, hi, row
    row_slot: torch.Tensor         # (num_rows,)
    split_rows: torch.Tensor       # (nsplit,)
    zero_rows: torch.Tensor        # (n_zero,)
    item_edges: int                # derive_walk's knob, as derived
    chunk_col: Optional[torch.Tensor] = None  # (nc,) K7's chunks' columns

    @property
    def nseg(self) -> int:
        return int(self.items.shape[0])

    @property
    def nsplit(self) -> int:
        return int(self.split_rows.shape[0])


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def derive_walk(ref: torch.Tensor, row: torch.Tensor, num_rows: int, *,
                refs_are_positions: bool,
                ids: Optional[torch.Tensor] = None,
                item_edges: int = ITEM_EDGES,
                label: str = "max/min") -> MinMaxSchedule:
    """The schedule of the real edges ``ref`` (ascending) of rows ``row``
    (int64, one device) whose ids are ``ids`` (None: the refs).  A row's
    edges are listed by id, so a warp that walks them in order keeps the
    lowest id of equal products with a strict compare.
    ``refs_are_positions``: the refs are CSR positions and the ids (K3), so
    an item is a range of them and ``order`` is None."""
    if item_edges < 1:
        raise ValueError(f"item_edges={item_edges}: an item takes at least "
                         "one edge")
    if ref.shape[0] >= 2**31:
        raise ValueError(f"{ref.shape[0]} edges: the int32 refs overflow")
    from .tiling_v2 import row_items

    t0 = time.perf_counter()
    if ids is not None:  # by id, and stably by row in row_items
        o = torch.argsort(ids, stable=True)
        ref, row = ref[o], row[o]
    it = row_items(row, ref, num_rows, item_edges)
    seg_ptr, seg_row = it["seg_ptr"].long(), it["seg_row"].long()
    lo, hi, order = seg_ptr[:-1], seg_ptr[1:], it["order"]
    if refs_are_positions:  # an item is a run of CSR positions
        o = order.long()
        lo, hi = o[lo], o[hi - 1] + 1
        order = None
    split_rows = torch.unique_consecutive(
        seg_row[1:][seg_row[1:] == seg_row[:-1]])
    row_slot = torch.full((num_rows,), -1, dtype=torch.int64,
                          device=ref.device)
    row_slot[split_rows] = torch.arange(split_rows.shape[0],
                                        device=ref.device)
    s = MinMaxSchedule(
        order=None if order is None else _i32(order),
        items=_i32(torch.stack([lo, hi, seg_row], 1)),
        row_slot=_i32(row_slot), split_rows=_i32(split_rows),
        zero_rows=_i32(torch.nonzero(it["row_ptr"].diff() == 0).flatten()),
        item_edges=int(item_edges))
    _log.info("%s schedule: %d edges in %d items of <= %d; %d split rows, "
              "%d rows without edges; derived in %.3fs", label,
              ref.shape[0], s.nseg, item_edges, s.nsplit,
              s.zero_rows.shape[0], time.perf_counter() - t0)
    return s
