"""The host side of the max/min walk that K3 (``spmm_minmax_v4``) and K7
(``spmm_minmax``) share (``csrc/minmax_walk.cuh``): the launch arguments
of one call, from a ``MinMaxSchedule`` and the operands."""

from __future__ import annotations

import ctypes

import torch

from ..sparse.minmax_sched import MinMaxSchedule

__all__ = ["Args", "launch_args", "pitched"]

_POINTERS = ("order", "items", "row_slot", "split_rows", "zero_rows", "x",
             "out", "arg", "scratch")
_INTS = ("nseg", "nsplit", "nzero", "num_rows", "num_cols", "k", "ldx",
         "negate", "sentinel")


class Args(ctypes.Structure):
    """``mmwalk::Args`` of ``csrc/minmax_walk.cuh``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _POINTERS]
                + [(f, ctypes.c_int) for f in _INTS])


def pitched(x: torch.Tensor) -> torch.Tensor:
    """x as the walk reads it: an odd K as a view of a copy padded with
    zero columns to a multiple of 4 (float4 loads; K = 41 ran 25-35%
    faster so than with floats, probe_minmax.py), else x itself."""
    k = x.shape[1]
    if k % 2 == 0:
        return x
    xp = x.new_zeros(x.shape[0], -(-k // 4) * 4)
    xp[:, :k] = x
    return xp[:, :k]


def launch_args(s: MinMaxSchedule, x: torch.Tensor, out: torch.Tensor,
                arg: torch.Tensor, scratch: torch.Tensor, num_rows: int,
                num_cols: int, k: int, negate: bool, sentinel: int) -> Args:
    """The walk's arguments: x (num_cols, ldx) with a row pitch ldx >= k
    (a padded copy of a ragged x reads as x), out and arg (num_rows, k),
    scratch (nsplit, k) int64 (the walk zeroes it).  The tensors must
    outlive the launch."""
    return Args(*(None if t is None else t.data_ptr() for t in (
        s.order, s.items, s.row_slot, s.split_rows, s.zero_rows, x, out, arg,
        scratch)), s.nseg, s.nsplit, s.zero_rows.shape[0], num_rows,
        num_cols, k, x.stride(0), int(negate), sentinel)
