"""Row-sharded SpMM with a halo exchange, the counterpart of
``isplib_tpu.dist.spmm_dist`` (``spmm_sharded``, ``pad_features``,
``unpad_output``, ``set_mesh``, ``get_mesh``).

Per shard (all shapes fixed by the partition):

    send  = x_loc[send_ids]        # (D, H, K) boundary rows for each shard
    halo  = all_to_all(send)       # (D·H, K) rows received from each shard
    out   = local SpMM over x_loc  +  halo SpMM over halo

An output row needs no reduction across shards.  Two meshes run it, the
counterparts of a JAX ``Mesh`` of D devices in one process and of one
spanning processes:

* :class:`LocalMesh` holds all D shards in this process, on x's device;
  ``x`` is global and the all_to_all is the exchange of the first two axes
  of the stacked (D_src, D_dst, H, K) send buffer, on the device;
* :class:`GroupMesh` holds one shard per rank of a ``torch.distributed``
  group; ``x`` is the rank's (rows_per_shard, K) rows and the exchange is
  ``all_to_all_single`` (gloo on CPU tensors, NCCL on CUDA tensors).

Three routes, as in the JAX package: sum/mean through the per-shard sum
plans (K1/K2 on ``HybridPlan``, K8 on ``TiledPlanV2``), max/min through
the with-eids plans (K7 on the local and the halo half, combined so that
the local half wins ties), and, without plans, the reference path per
shard, which torch autograd differentiates.  The tiled routes are
``torch.autograd.Function``s whose backward runs the transpose plans (or
routes the cotangent through the winning edges) and returns the halo rows'
gradients through the reverse exchange.  Their edge values are baked into
the plans, so they raise when the values require a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..kernels.spmm_hybrid import spmm_hybrid
from ..kernels.spmm_minmax import spmm_minmax_v2
from ..kernels.spmm_v2 import spmm_v2
from ..ops import reference
from ..ops.semiring import Reduce
from ..sparse.tiling_v5 import HybridPlan
from .partition import ShardedGraph

__all__ = ["LocalMesh", "GroupMesh", "spmm_sharded", "pad_features",
           "unpad_output", "set_mesh", "get_mesh"]

_MESH = None


class LocalMesh:
    """All shards in this process, on x's device: the partition must hold
    every shard.  ``size``, if given, must equal its shard count."""

    def __init__(self, size: Optional[int] = None):
        self.size = size

    def local(self, sg: ShardedGraph) -> range:
        if self.size is not None and self.size != sg.num_shards:
            raise ValueError(f"LocalMesh({self.size}) cannot hold a "
                             f"partition of {sg.num_shards} shards")
        if len(sg.held) != sg.num_shards:
            raise ValueError(f"LocalMesh runs every shard; this partition "
                             f"holds {sg.held} of {sg.num_shards}")
        return range(sg.num_shards)

    @staticmethod
    def split(sg: ShardedGraph, x: torch.Tensor) -> list[torch.Tensor]:
        """Global rows → each shard's (rps, K) rows."""
        return list(pad_features(sg, x).reshape(
            sg.num_shards, sg.rows_per_shard, x.shape[1]).unbind(0))

    @staticmethod
    def out_rows(sg: ShardedGraph) -> int:
        return sg.num_rows

    @staticmethod
    def exchange(sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[i]`` (D, H, K): what shard i sends to each shard →
        ``recv[j]`` (D·H, K): what shard j receives from each shard."""
        d, h, k = sends[0].shape
        return list(torch.stack(sends).transpose(0, 1).reshape(
            d, d * h, k).unbind(0))


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of a (D, H, K) buffer; its backward is the
    reverse exchange, which is the same collective."""

    @staticmethod
    def forward(ctx, send: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_to_all(g, ctx.group), None


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


class GroupMesh:
    """One shard per rank of a ``torch.distributed`` group (the default
    group when ``group`` is None); ``x`` is the rank's (rps, K) rows and
    the result the rank's (rps, K) output rows.  Each rank partitions with
    ``hold=[rank]``, so it keeps its own shard's arrays and plans only."""

    def __init__(self, group=None):
        self.group = group

    def local(self, sg: ShardedGraph) -> list[int]:
        size = dist.get_world_size(self.group)
        if size != sg.num_shards:
            raise ValueError(f"a group of {size} ranks cannot hold a "
                             f"partition of {sg.num_shards} shards")
        return [dist.get_rank(self.group)]

    @staticmethod
    def split(sg: ShardedGraph, x: torch.Tensor) -> list[torch.Tensor]:
        if x.shape[0] != sg.rows_per_shard:
            raise ValueError(f"a rank holds its {sg.rows_per_shard} rows of "
                             f"x, got {x.shape[0]}")
        return [x.contiguous()]

    @staticmethod
    def out_rows(sg: ShardedGraph) -> int:
        return sg.rows_per_shard

    def exchange(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        (send,) = sends
        d, h, k = send.shape
        return [_AllToAll.apply(send, self.group).reshape(d * h, k)]


def set_mesh(mesh) -> None:
    """Set the process-default mesh that ``spmm`` uses for a ShardedGraph
    (inside the layers, which pass none)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    """The mesh set by :func:`set_mesh`; else a :class:`GroupMesh` of the
    default group when ``torch.distributed`` is initialised, else a
    :class:`LocalMesh` (JAX's default mesh is all devices)."""
    if _MESH is not None:
        return _MESH
    if dist.is_available() and dist.is_initialized():
        return GroupMesh()
    return LocalMesh()


def pad_features(sg: ShardedGraph, x: torch.Tensor) -> torch.Tensor:
    """Global features padded to the partition's num_shards · rps rows."""
    total = sg.num_shards * sg.rows_per_shard
    if x.shape[0] == total:
        return x
    return torch.cat([x, x.new_zeros(total - x.shape[0], x.shape[1])])


def unpad_output(sg: ShardedGraph, out: torch.Tensor) -> torch.Tensor:
    return out[: sg.num_rows]


def _send(sh, x_loc: torch.Tensor) -> torch.Tensor:
    """(D, H, K) rows this shard sends; pad ids hit the phantom zero row."""
    d, h = sh.send_ids.shape
    return reference.gather_rows(x_loc, sh.send_ids.reshape(-1)).view(
        d, h, x_loc.shape[1])


def _receive(sh, back: torch.Tensor, rps: int) -> torch.Tensor:
    """Add the (D·H, K) gradients returned for the rows this shard sent
    into its (rps, K) rows; pads land in a dump row that is cut off."""
    return back.new_zeros(rps + 1, back.shape[1]).index_add_(
        0, sh.send_ids.reshape(-1), back)[:rps]


def _run(plan, x: torch.Tensor) -> torch.Tensor:
    """Sum-SpMM of one shard plan: K1/K2 for a HybridPlan, else K8."""
    if isinstance(plan, HybridPlan):
        return spmm_hybrid(plan, x)
    return spmm_v2(plan, x)


class _TiledSum(torch.autograd.Function):
    """Sum-SpMM through the per-shard sum plans; the backward runs the
    transpose plans and returns the halo rows' gradients to their
    senders.  ``skip_halo``: a partition without halo edges (one shard)
    runs the local plan alone, with no exchange."""

    @staticmethod
    def forward(ctx, sg: ShardedGraph, mesh, x: torch.Tensor) -> torch.Tensor:
        shards = [sg.shard(i) for i in mesh.local(sg)]
        xs = mesh.split(sg, x)
        outs = [_run(sh.plans[0], xi) for sh, xi in zip(shards, xs)]
        if sg.halo_edges:
            halo = mesh.exchange([_send(sh, xi)
                                  for sh, xi in zip(shards, xs)])
            outs = [o + _run(sh.plans[2], hi)
                    for o, sh, hi in zip(outs, shards, halo)]
        ctx.sg, ctx.mesh, ctx.rows = sg, mesh, x.shape[0]
        return torch.cat(outs)[: mesh.out_rows(sg)]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        sg, mesh = ctx.sg, ctx.mesh
        shards = [sg.shard(i) for i in mesh.local(sg)]
        gs = mesh.split(sg, g.contiguous())
        gx = [_run(sh.plans[1], gi) for sh, gi in zip(shards, gs)]
        if sg.halo_edges:
            d, h, k = sg.num_shards, sg.halo, g.shape[1]
            back = mesh.exchange([_run(sh.plans[3], gi).view(d, h, k)
                                  for sh, gi in zip(shards, gs)])
            gx = [gi + _receive(sh, bi, sg.rows_per_shard)
                  for gi, sh, bi in zip(gx, shards, back)]
        return None, None, torch.cat(gx)[: ctx.rows]


def _route(k: int, arg: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
           mask: torch.Tensor, g: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, K) gradient of x through the winning edges ``arg`` (ids into
    the edge arrays ``col``, ``val``) where ``mask``; column ``rows`` (the
    pads') is a dump row that is cut off."""
    a = arg.long()
    flat = (col.long()[a] * k + torch.arange(k, device=g.device)).reshape(-1)
    contrib = torch.where(mask, val[a] * g, 0.0).reshape(-1)
    return g.new_zeros((rows + 1) * k).index_add_(0, flat, contrib).view(
        rows + 1, k)[:rows]


class _TiledMinMax(torch.autograd.Function):
    """Max/min through K7 on the local and the halo half of every shard,
    with the JAX package's presence-aware combine: a half without edges in
    a row does not compete, and the local half wins ties.  The backward
    routes the cotangent through each (row, feature)'s winning edge, the
    halo winners' share back through the reverse exchange."""

    @staticmethod
    def forward(ctx, sg: ShardedGraph, mesh, reduce: Reduce,
                x: torch.Tensor) -> torch.Tensor:
        shards = [sg.shard(i) for i in mesh.local(sg)]
        xs = mesh.split(sg, x)
        sent_l = sg.row_loc.shape[1] - 1   # the last slot is always a pad
        sent_h = sg.row_halo.shape[1] - 1
        halo = (mesh.exchange([_send(sh, xi) for sh, xi in zip(shards, xs)])
                if sg.halo_edges else [None] * len(shards))
        outs, saved = [], []
        for sh, xi, hi in zip(shards, xs, halo):
            a, a_arg = spmm_minmax_v2(sh.plans_mm[0], xi, reduce, sent_l)
            pa = a_arg != sent_l
            if hi is None:
                outs.append(a)
                saved.append((a_arg, pa, None, None))
                continue
            b, b_arg = spmm_minmax_v2(sh.plans_mm[1], hi, reduce, sent_h)
            pb = b_arg != sent_h
            better_b = b > a if reduce is Reduce.MAX else b < a
            use_b = ~pa | (pb & better_b)
            outs.append(torch.where(pa | pb, torch.where(use_b, b, a), 0.0))
            saved.append((a_arg, pa & ~use_b, b_arg, use_b & pb))
        ctx.sg, ctx.mesh, ctx.rows, ctx.saved = sg, mesh, x.shape[0], saved
        return torch.cat(outs)[: mesh.out_rows(sg)]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        sg, mesh = ctx.sg, ctx.mesh
        shards = [sg.shard(i) for i in mesh.local(sg)]
        gs = mesh.split(sg, g.contiguous())
        rps, k = sg.rows_per_shard, g.shape[1]
        gx = [_route(k, a_arg, sh.col_loc, sh.val_loc, mask_a, gi, rps)
              for sh, gi, (a_arg, mask_a, _, _) in zip(shards, gs,
                                                       ctx.saved)]
        if sg.halo_edges:
            d, h = sg.num_shards, sg.halo
            back = mesh.exchange([
                _route(k, b_arg, sh.col_halo, sh.val_halo, mask_b, gi,
                       d * h).view(d, h, k)
                for sh, gi, (_, _, b_arg, mask_b) in zip(shards, gs,
                                                         ctx.saved)])
            gx = [gi + _receive(sh, bi, rps)
                  for gi, sh, bi in zip(gx, shards, back)]
        return None, None, None, torch.cat(gx)[: ctx.rows]


def _reference(sg: ShardedGraph, mesh, x: torch.Tensor,
               reduce: Reduce) -> torch.Tensor:
    """The reference path per shard on the padded edge arrays; max/min
    combine the halves at the ±inf identity, then zero the rows that have
    no edge in the whole graph."""
    shards = [sg.shard(i) for i in mesh.local(sg)]
    xs = mesh.split(sg, x)
    halo = mesh.exchange([_send(sh, xi) for sh, xi in zip(shards, xs)])
    rps = sg.rows_per_shard
    outs = []
    for sh, xi, hi in zip(shards, xs, halo):
        loc = (sh.row_loc, sh.col_loc, sh.val_loc, sh.deg, xi, rps)
        hal = (sh.row_halo, sh.col_halo, sh.val_halo, sh.deg, hi, rps)
        if reduce in (Reduce.SUM, Reduce.MEAN):
            out = (reference.spmm_raw(*loc, Reduce.SUM)
                   + reference.spmm_raw(*hal, Reduce.SUM))
            if reduce is Reduce.MEAN:
                out = out / sh.deg.clamp(min=1.0)[:, None]
        else:
            a = reference.spmm_raw(*loc, reduce, empty_to_zero=False)
            b = reference.spmm_raw(*hal, reduce, empty_to_zero=False)
            out = torch.maximum(a, b) if reduce is Reduce.MAX else \
                torch.minimum(a, b)
            out = torch.where((sh.deg > 0)[:, None], out + 0.0,
                              torch.zeros_like(out))
        outs.append(out)
    return torch.cat(outs)[: mesh.out_rows(sg)]


def spmm_sharded(sg: ShardedGraph, x: torch.Tensor,
                 reduce: str | Reduce = "sum", mesh=None) -> torch.Tensor:
    """SpMM over a row-partitioned graph, differentiable in x.

    On a :class:`LocalMesh` (the default without ``torch.distributed``)
    ``x`` is the global (num_rows or padded, K) features and the result
    the global (num_rows, K); on a :class:`GroupMesh` both are the rank's
    (rows_per_shard, K) rows.
    """
    mesh = mesh if mesh is not None else get_mesh()
    reduce = Reduce.of(reduce)
    if x.device != sg.device:
        raise ValueError(f"x is on {x.device}, the partition on "
                         f"{sg.device}")
    if ((sg.plans is not None or sg.plans_mm is not None)
            and (sg.val_loc.requires_grad or sg.val_halo.requires_grad)):
        raise ValueError(
            "the sharded tiled SpMM treats edge values as constants (they "
            "are baked into the per-shard plans); differentiating in the "
            "values needs the reference route: partition with tiling=None")
    if sg.plans_mm is not None and reduce in (Reduce.MAX, Reduce.MIN):
        return _TiledMinMax.apply(sg, mesh, reduce, x)
    if sg.plans is not None and reduce in (Reduce.SUM, Reduce.MEAN):
        out = _TiledSum.apply(sg, mesh, x)
        if reduce is Reduce.MEAN:
            deg = torch.cat([sg.shard(i).deg for i in mesh.local(sg)])
            out = out / deg[: out.shape[0]].clamp(min=1.0)[:, None]
        return out
    return _reference(sg, mesh, x, reduce)
