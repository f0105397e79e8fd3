"""Row-partitioned graphs for the sharded SpMM, the counterpart of
``isplib_tpu.dist.partition`` (``ShardedGraph``, ``partition_rows``).

Nodes, and with them adjacency rows and feature rows, are cut into
``num_shards`` contiguous blocks of ``rows_per_shard`` (rps).  Shard i owns
its rows and the edges into them, so an output row needs no reduction
across shards.  Each shard's edges split into a local set, whose columns
the shard owns (``*_loc``, columns in ``[0, rps]``, rps being a phantom
zero row for pads), and a halo set, whose columns other shards own
(``*_halo``, columns in the received-halo space ``[0, D·halo]``: position
``s·halo + j`` is the j-th row received from shard s, ``D·halo`` the pad).
``send_ids[i, j]`` lists the local rows shard i sends to shard j, padded
with rps.  The host build is the JAX package's numpy build, edge for edge,
so every array equals its counterpart.

With ``tiling`` each shard also gets its kernel plans: four sum plans
(local forward, local transpose, halo forward, halo transpose), the port's
``HybridPlan`` (K1/K2, the default ``version`` 5) or ``TiledPlanV2`` (K8,
``version`` 2), and, unless ``minmax`` is False, the with-eids local and
halo ``TiledPlanV2`` of the max/min kernel (K7).  Their geometry is the JAX
package's shard configuration, fixed.  The JAX package pads the shards'
plans to one common shape and stacks them, because ``shard_map`` needs
static shapes; PyTorch runs each shard's kernels on its own plan, so the
port keeps a list of per-shard plans instead.

A process holds only the shards it runs (``hold``): all of them for a
``LocalMesh``, its rank's for a ``GroupMesh``.  The host build needs every
edge (the halo map is global), but only the held shards' arrays go to the
device and only their plans are built.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..sparse.plan_cache import tree_to
from ..sparse.tiling_v2 import build_plan_v2_arrays
from ..sparse.tiling_v5 import build_hybrid_plan

__all__ = ["ShardedGraph", "Shard", "partition_rows"]

_ARRAY_FIELDS = ("row_loc", "col_loc", "val_loc", "row_halo", "col_halo",
                 "val_halo", "deg", "send_ids")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


# the JAX package's shard plans (``isplib_tpu/dist/partition.py``): v2 sum
# plans, the max/min plans (a smaller output superblock), and the v5
# hybrid plans' dense-block threshold
_V2_SUM = dict(rb=128, ct=128, eb=512, k=32, vmem_out_bytes=6 << 20)
_V2_MINMAX = dict(_V2_SUM, vmem_out_bytes=2 << 20)
_V5_DENSE_THRESHOLD = 64


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's tensors and plans (``ShardedGraph.shard(i)``)."""

    row_loc: torch.Tensor    # (EL,) int32, pad rps
    col_loc: torch.Tensor    # (EL,) int32, pad rps
    val_loc: torch.Tensor    # (EL,) float32, pad 0
    row_halo: torch.Tensor   # (EH,) int32, pad rps
    col_halo: torch.Tensor   # (EH,) int32, pad D·halo
    val_halo: torch.Tensor   # (EH,) float32, pad 0
    deg: torch.Tensor        # (rps,) float32, global in-degree
    send_ids: torch.Tensor   # (D, H) int32, pad rps
    plans: Optional[tuple]     # (loc fwd, loc bwd, halo fwd, halo bwd)
    plans_mm: Optional[tuple]  # with-eids (loc, halo)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Per-shard COO split into local and halo edge sets.  The array fields
    carry a leading axis of the held shards (``held``, ascending ids), the
    plans are one tuple per held shard.
    """

    row_loc: torch.Tensor    # (S, EL) int32 local rows, sorted; pad rps
    col_loc: torch.Tensor    # (S, EL) int32 local columns; pad rps
    val_loc: torch.Tensor    # (S, EL) float32; pad 0
    row_halo: torch.Tensor   # (S, EH) int32 local rows; pad rps
    col_halo: torch.Tensor   # (S, EH) int32 halo-space columns; pad D·halo
    val_halo: torch.Tensor   # (S, EH) float32; pad 0
    deg: torch.Tensor        # (S, rps) float32 true in-degree of each row
    send_ids: torch.Tensor   # (S, D, H) int32 rows shard i sends to j
    num_rows: int            # global
    rows_per_shard: int
    halo: int                # H, rows per (sender, receiver) pair
    num_shards: int          # D
    nnz: int                 # global, real edges
    held: tuple[int, ...]    # the S shard ids held here, ascending
    local_edges: int = 0
    halo_edges: int = 0
    plans: Optional[tuple] = None     # per shard (loc fwd, loc bwd, halo
    #                                   fwd, halo bwd)
    plans_mm: Optional[tuple] = None  # per shard with-eids (loc, halo);
    # their arg ids index the shard's row_loc/col_loc (resp. *_halo)

    @property
    def halo_fraction(self) -> float:
        """Fraction of real edges that need a remote feature row."""
        return self.halo_edges / max(self.nnz, 1)

    @property
    def device(self) -> torch.device:
        return self.row_loc.device

    def to(self, device: str | torch.device) -> "ShardedGraph":
        dev = resolve_device(device)
        if dev == self.device:
            return self

        def plans(ps):
            return None if ps is None else tuple(
                tuple(tree_to(p, dev) for p in shard) for shard in ps)

        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in _ARRAY_FIELDS},
            plans=plans(self.plans), plans_mm=plans(self.plans_mm))

    def shard(self, i: int) -> Shard:
        """Shard ``i``'s tensors and plans; it must be held here."""
        if i not in self.held:
            raise ValueError(f"shard {i} is not held here (held: "
                             f"{self.held})")
        j = self.held.index(i)
        return Shard(
            **{f: getattr(self, f)[j] for f in _ARRAY_FIELDS},
            plans=None if self.plans is None else self.plans[j],
            plans_mm=None if self.plans_mm is None else self.plans_mm[j])

    def without_plans(self) -> "ShardedGraph":
        """The same partition on the reference route (no kernel plans)."""
        return dataclasses.replace(self, plans=None, plans_mm=None)


def _row_sorted(r, c, v):
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


def _shard_plans(loc_sets, halo_sets, rps, halo_space, version, dev):
    """Per shard (local fwd, local bwd, halo fwd, halo bwd) sum plans."""
    if version == 5:
        def plan(r, c, v, nr, ncl):
            return build_hybrid_plan(*_row_sorted(r, c, v), nr, ncl, dev,
                                     dense_threshold=_V5_DENSE_THRESHOLD)
    else:
        def plan(r, c, v, nr, ncl):
            return build_plan_v2_arrays(r, c, v, nr, ncl, device=dev,
                                        **_V2_SUM)

    return tuple((plan(lr, lc, lv, rps, rps), plan(lc, lr, lv, rps, rps),
                  plan(hr, hc, hv, rps, halo_space),
                  plan(hc, hr, hv, halo_space, rps))
                 for (lr, lc, lv), (hr, hc, hv) in zip(loc_sets, halo_sets))


def _shard_minmax_plans(loc_sets, halo_sets, rps, halo_space, dev):
    """Per shard with-eids (local, halo) plans of the max/min kernel; arg
    ids index each shard's local and halo edge sets."""
    cfg = dict(_V2_MINMAX, with_eids=True, device=dev)
    return tuple(
        (build_plan_v2_arrays(lr, lc, lv, rps, rps, **cfg),
         build_plan_v2_arrays(hr, hc, hv, rps, halo_space, **cfg))
        for (lr, lc, lv), (hr, hc, hv) in zip(loc_sets, halo_sets))


def _tiling_options(tiling: dict) -> tuple[int, bool]:
    """``(version, minmax)`` of a ``tiling`` dict; any other key raises."""
    unknown = set(tiling) - {"version", "minmax"}
    if unknown:
        raise ValueError(f"tiling takes 'version' and 'minmax' only, got "
                         f"{sorted(unknown)}: the shard plans' geometry is "
                         "fixed")
    version = tiling.get("version", 5)
    if version not in (2, 5):
        raise ValueError(f"tiling version must be 5 or 2, got {version!r}")
    return version, bool(tiling.get("minmax", True))


def partition_rows(
    row: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows: int,
    num_shards: int,
    edge_multiple: int = 512,
    halo_multiple: int = 128,
    verbose: bool = False,
    tiling: Optional[dict] = None,
    device: str | torch.device = "cuda",
    hold: Optional[Sequence[int]] = None,
) -> ShardedGraph:
    """Partition a square adjacency, given as host COO arrays of its real
    edges, by contiguous row blocks, on ``device``.

    Features go with the same partition: ``spmm_sharded`` pads them to
    ``num_shards · rows_per_shard`` rows.  ``tiling`` (a dict) builds the
    per-shard plans: ``version`` 5 (default, hybrid plans with a dense
    threshold of 64) or 2 (v2 plans with rb, ct, eb, k = 128, 128, 512,
    32 and a 6 MiB superblock), and ``minmax`` (default True) for the
    max/min plans (the same with a 2 MiB superblock): the JAX package's
    shard configuration.  Any other key raises.  ``hold`` lists the shards
    this process keeps (default all; a ``GroupMesh`` rank holds its own).
    """
    dev = resolve_device(device)
    options = None if tiling is None else _tiling_options(dict(tiling))
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    nnz = int(row.shape[0])
    if value is None:
        value = np.ones(nnz, np.float32)
    value = np.asarray(value, np.float32)

    d = num_shards
    rps = _cdiv(num_rows, d)
    held = tuple(range(d)) if hold is None else tuple(sorted(set(hold)))
    if not held or not all(0 <= i < d for i in held):
        raise ValueError(f"hold must name shards of 0..{d - 1}, got {hold}")

    # one stable sort by owning shard, then per-shard contiguous slices
    owner = row // rps
    if not bool(np.all(row[1:] >= row[:-1])):
        o = np.argsort(row, kind="stable")
        row, col, value, owner = row[o], col[o], value[o], owner[o]

    deg_global = np.bincount(row, minlength=rps * d).astype(np.float32)

    col_owner = col // rps
    is_halo = col_owner != owner
    he = np.flatnonzero(is_halo)

    # the global halo map: unique (receiver, col) pairs, sorted, so the
    # columns of each (receiver, sender) pair come in ascending order on
    # both sides
    span = np.int64(rps) * d
    uk, inv = np.unique(owner[he] * span + col[he], return_inverse=True)
    u_recv = uk // span
    u_col = uk % span
    u_send = u_col // rps
    pair = u_recv * d + u_send
    pair_counts = np.bincount(pair, minlength=d * d)
    halo = _round_up(max(int(pair_counts.max(initial=0)), 1), halo_multiple)
    pair_start = np.zeros(d * d + 1, np.int64)
    np.cumsum(pair_counts, out=pair_start[1:])
    pos_u = np.arange(len(uk), dtype=np.int64) - pair_start[pair]

    c_halo_of_edge = u_send[inv] * halo + pos_u[inv]
    halo_sentinel = d * halo
    send_ids = np.full((d, d, halo), rps, np.int32)  # pad → zero row
    send_ids[u_send, u_recv, pos_u] = (u_col - u_send * rps).astype(np.int32)

    n_halo = int(he.shape[0])
    n_loc = nnz - n_halo

    # every shard's local then halo edges as contiguous row-ordered runs
    order2 = np.argsort(owner * 2 + is_halo, kind="stable")
    row2, col2, val2 = row[order2], col[order2], value[order2]
    c_halo_all = np.empty(nnz, np.int64)
    c_halo_all[he] = c_halo_of_edge
    ch2 = c_halo_all[order2]
    seg = np.searchsorted((owner * 2 + is_halo)[order2], np.arange(2 * d + 1))

    loc_counts = seg[1::2] - seg[0:-1:2]
    halo_counts = seg[2::2] - seg[1::2]
    el_max = _round_up(int(loc_counts.max(initial=0)) + 1, edge_multiple)
    eh_max = _round_up(int(halo_counts.max(initial=0)) + 1, edge_multiple)

    # the held shards' padded arrays (the pad widths are global)
    n_held = len(held)
    row_loc = np.full((n_held, el_max), rps, np.int32)
    col_loc = np.full((n_held, el_max), rps, np.int32)  # pads: phantom local row
    val_loc = np.zeros((n_held, el_max), np.float32)
    row_halo = np.full((n_held, eh_max), rps, np.int32)
    col_halo = np.full((n_held, eh_max), halo_sentinel, np.int32)
    val_halo = np.zeros((n_held, eh_max), np.float32)

    loc_sets, halo_sets = [], []
    for j, i in enumerate(held):
        s0, s1, s2 = seg[2 * i], seg[2 * i + 1], seg[2 * i + 2]
        n = s1 - s0
        row_loc[j, :n] = row2[s0:s1] - i * rps
        col_loc[j, :n] = col2[s0:s1] - i * rps
        val_loc[j, :n] = val2[s0:s1]
        loc_sets.append((row_loc[j, :n].astype(np.int64),
                         col_loc[j, :n].astype(np.int64),
                         val_loc[j, :n].copy()))
        n = s2 - s1
        row_halo[j, :n] = row2[s1:s2] - i * rps
        col_halo[j, :n] = ch2[s1:s2]
        val_halo[j, :n] = val2[s1:s2]
        halo_sets.append((row_halo[j, :n].astype(np.int64),
                          col_halo[j, :n].astype(np.int64),
                          val_halo[j, :n].copy()))

    if verbose:
        pc = pair_counts.reshape(d, d)
        live = pc[pc > 0]
        print(f"[isplib_tpu_torch.dist] partition: {d} shards, rps={rps}, "
              f"halo={halo}/pair (pair rows: max={int(pc.max(initial=0))} "
              f"mean={float(live.mean()) if live.size else 0:.0f}), "
              f"local_edges={n_loc} halo_edges={n_halo} "
              f"({100 * n_halo / max(nnz, 1):.1f}%)", file=sys.stderr)

    plans = plans_mm = None
    if options is not None:
        version, minmax = options
        plans = _shard_plans(loc_sets, halo_sets, rps, halo_sentinel,
                             version, dev)
        if minmax:
            plans_mm = _shard_minmax_plans(loc_sets, halo_sets, rps,
                                           halo_sentinel, dev)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ShardedGraph(
        row_loc=t(row_loc), col_loc=t(col_loc), val_loc=t(val_loc),
        row_halo=t(row_halo), col_halo=t(col_halo), val_halo=t(val_halo),
        deg=t(deg_global.reshape(d, rps)[list(held)]),
        send_ids=t(send_ids[list(held)]), num_rows=num_rows,
        rows_per_shard=rps, halo=halo, num_shards=d, nnz=nnz, held=held,
        local_edges=n_loc, halo_edges=n_halo, plans=plans, plans_mm=plans_mm)
