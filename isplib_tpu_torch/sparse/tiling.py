"""A graph with its SpMM plans, the counterpart of ``isplib_tpu.sparse.tiling``
(``TiledPlan``, ``build_tiling_from_numpy``, ``build_tiling``,
``auto_tile``).

``fwd`` drives sum/mean ``spmm(A, x)`` and ``bwd`` is the plan of Aᵀ, built
from the CSC arrays, for ``grad_x = spmm(Aᵀ, g)``, or ``None`` for a tiling
built with ``build_backward=False``, whose ``grad_x`` then runs the
reference transpose path.  The backward never runs the forward plan: that
would compute ``spmm(A, g)``.  ``fwd`` and ``bwd`` are of one plan version:

====  =================================  =====================================
 5    ``HybridPlan`` (``tiling_v5``)      dense blocks (K2) + residual (K1)
 4    ``HybridPlan``, every edge residual K1
 3    ``HybridPlanV3`` (``tiling_v3``)    celled BSR blocks (K9) + v2 (K8)
 2    ``TiledPlanV2`` (``tiling_v2``)     K8
 1    ``TiledPlan`` (here)                K10
====  =================================  =====================================

``fwd_mm`` is a segment work list over the CSR: it drives the SDDMM (K4),
the FusedMM forward (K5) and its ``grad_x`` pass (K6 pass A), and its
schedule (``fwd_mm.sched``) max/min ``spmm(A, x)`` with the winning edge
ids (K3).  ``bwd_mm`` is the same list over
the CSC, the rows of Aᵀ: the FusedMM ``grad_y`` pass (K6 pass B) walks it.
Both are built for every version.  The JAX package runs its FusedMM kernel
only on a ``version=4`` tiling and its SDDMM kernel only on a tiling with
the with-eids v2 plan; the port's lists serve every version, and the
functions computed are the same.

The port's default ``version`` is 5, the plan every caller of the port
relies on; the JAX package's default is 2.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Optional, Union

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..utils import profiling
from .graph import CSRGraph
from .tiling_v2 import TiledPlanV2, build_plan_v2_arrays, row_items
from .tiling_v3 import HybridPlanV3, build_plan_v3_arrays
from .tiling_v4mm import MinMaxPlan, build_minmax_plan
from .tiling_v5 import HybridPlan, build_hybrid_plan

__all__ = ["TiledPlan", "RowSchedule", "TiledGraph", "build_tiling",
           "build_tiling_from_numpy", "save_tiling", "auto_tile",
           "derive_row_schedule", "base_graph", "AUTO_TILE_MIN_NNZ",
           "PLAN_KEYS", "SEG_SLOTS"]

# Below this edge count the reference path is fast enough and the plan
# build would dominate (the JAX package's threshold).
AUTO_TILE_MIN_NNZ = 1_000_000

_LANE = 128
SEG_SLOTS = 256  # real slots a K10 warp takes at most (one row's)

_log = logging.getLogger(__name__)

# The keys that shape each version's plan in the port.  The JAX package's
# v5 keys rb, S, g and gd shape its column stripes and DMA groups, which the
# Hopper HybridPlan does not have; version 4 puts every edge in the residual
# half, so no key shapes it (JAX's v4 plan takes no dense_threshold either).
PLAN_KEYS = {
    5: ("dense_threshold",),
    4: (),
    3: ("rb", "ct", "eb", "dense_threshold", "g", "gd", "vmem_out_bytes"),
    2: ("rb", "ct", "eb", "gd", "vmem_out_bytes"),
    1: ("rb", "ct", "eb"),
}
# the row block, column tile and chunk of versions 1-3 unless given
_GEOMETRY = dict(rb=256, ct=512, eb=512)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RowSchedule:
    """K10's walk over a ``TiledPlan``, derived from its JAX-equal arrays.

    ``order`` (n_real,) int32: every real slot (value not 0) as its flat
    index ``chunk·eb + slot``, sorted by (global row, flat index), so pad
    slots are never read; ``row_ptr`` (num_rows + 1,) int32: each row's
    range in ``order``; ``seg_ptr`` (nseg + 1,) and ``seg_row`` (nseg,)
    int32: the rows cut into work items of at most ``SEG_SLOTS`` slots (a
    row without slots has none)."""

    order: torch.Tensor
    row_ptr: torch.Tensor
    seg_ptr: torch.Tensor
    seg_row: torch.Tensor

    @property
    def nseg(self) -> int:
        return int(self.seg_row.shape[0])


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """Chunked edge list (v1) for one direction, grouped by row block.

    ``edges`` (nc, 3, eb/128, 128) int32: plane 0 the row within the row
    block, plane 1 the column within the column tile, plane 2 the float32
    value's bits; pad slots are 0, 0, 0.0.  ``rb_ids`` / ``ct_ids`` (nc,)
    give each chunk's row block and column tile, ``chunk_starts`` (nrb + 1,)
    each row block's chunk range.  A chunk holds the edges of one (row
    block, column tile) bucket in row order; a row block with no edges has
    one all-pad chunk.  ``fill`` is real edges over chunk slots.  ``sched``
    is K10's schedule, beside those arrays.
    """

    edges: torch.Tensor         # (nc, 3, eb/128, 128) int32
    rb_ids: torch.Tensor        # (nc,) int32
    ct_ids: torch.Tensor        # (nc,) int32
    chunk_starts: torch.Tensor  # (nrb + 1,) int32
    rb: int
    ct: int
    eb: int
    nc: int
    num_rows: int
    num_cols: int
    fill: float = 1.0
    sched: Optional[RowSchedule] = None

    @property
    def nrb(self) -> int:
        return _cdiv(self.num_rows, self.rb)

    @property
    def r_padded(self) -> int:
        return self.nrb * self.rb

    @property
    def c_padded(self) -> int:
        return _cdiv(self.num_cols, self.ct) * self.ct

    @property
    def device(self) -> torch.device:
        return self.edges.device

    def slots(self) -> dict[str, torch.Tensor]:
        """Every slot as flat (nc·eb,) tensors: global ``row`` and ``col``
        (int64) and ``val`` (float32, 0 on pad slots)."""
        e = self.edges.reshape(self.nc, 3, self.eb)
        return dict(
            row=(self.rb_ids.long()[:, None] * self.rb
                 + e[:, 0].long()).reshape(-1),
            col=(self.ct_ids.long()[:, None] * self.ct
                 + e[:, 1].long()).reshape(-1),
            val=e[:, 2].contiguous().view(torch.float32).reshape(-1))


def build_plan_v1_arrays(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                         num_rows: int, num_cols: int, rb: int = 256,
                         ct: int = 512, eb: int = 512,
                         device: str | torch.device = "cuda") -> TiledPlan:
    """The v1 plan of host COO arrays (the JAX package's
    ``_build_plan_arrays``), moved to ``device``.  Row-sorted edges take
    the native build (``native.plan_chunks``), any other input the numpy
    build, the reference; both give the same arrays."""
    if eb % _LANE:
        raise ValueError(f"the chunk size eb={eb} must be a multiple of 128")
    if rb % 8 or ct % 8:
        raise ValueError(f"rb={rb} and ct={ct} must be multiples of 8")
    dev = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    nnz = int(row.shape[0])
    nrb = _cdiv(num_rows, rb)
    nct = _cdiv(num_cols, ct)

    if nnz and native.available() and bool(np.all(row[1:] >= row[:-1])):
        edges, rb_ids, ct_ids, chunk_starts = native.plan_chunks(
            row, col, val, num_rows, num_cols, rb, ct, eb)
        nc = edges.shape[0]
        return _v1_plan(edges.reshape(nc, 3, eb // _LANE, _LANE), rb_ids,
                        ct_ids, chunk_starts, rb, ct, eb, num_rows, num_cols,
                        float(nnz) / max(nc * eb, 1), dev)
    if nnz:
        rbid, ctid = row // rb, col // ct
        order = np.lexsort((row, ctid, rbid))
        row, col, val = row[order], col[order], val[order]
        rbid, ctid = rbid[order], ctid[order]
        # a chunk starts at a new (row block, column tile) or every eb edges
        bucket = rbid * nct + ctid
        new_bucket = np.empty(nnz, bool)
        new_bucket[0] = True
        np.not_equal(bucket[1:], bucket[:-1], out=new_bucket[1:])
        bucket_start = np.flatnonzero(new_bucket)
        pos = np.arange(nnz, dtype=np.int64) - bucket_start[
            np.cumsum(new_bucket) - 1]
        new_chunk = new_bucket.copy()
        np.logical_or(new_chunk[1:], (pos // eb)[1:] != (pos // eb)[:-1],
                      out=new_chunk[1:])
        chunk_id = np.cumsum(new_chunk) - 1
        nc_real = int(chunk_id[-1]) + 1
        slot = pos % eb
        present = np.unique(rbid)
    else:
        nc_real = 0
        present = np.empty(0, np.int64)
    missing = np.setdiff1d(np.arange(nrb, dtype=np.int64), present)
    nc = nc_real + len(missing)

    planes = np.zeros((3, nc, eb), np.int32)
    rb_ids = np.zeros(nc, np.int64)
    ct_ids = np.zeros(nc, np.int64)
    if nnz:
        planes[0, chunk_id, slot] = row - rbid * rb
        planes[1, chunk_id, slot] = col - ctid * ct
        planes[2, chunk_id, slot] = val.view(np.int32)
        first_edge = np.flatnonzero(new_chunk)
        rb_ids[:nc_real] = rbid[first_edge]
        ct_ids[:nc_real] = ctid[first_edge]
    rb_ids[nc_real:] = missing  # all-pad chunks: their row blocks' zeros
    # contiguous chunk ranges per row block (the all-pad chunks trail)
    chunk_starts = np.zeros(nrb + 1, np.int64)
    chunk_starts[1:] = np.cumsum(np.bincount(rb_ids, minlength=nrb))
    order2 = np.argsort(rb_ids, kind="stable")
    edges = planes[:, order2].transpose(1, 0, 2).reshape(
        nc, 3, eb // _LANE, _LANE)
    return _v1_plan(edges, rb_ids[order2], ct_ids[order2], chunk_starts, rb,
                    ct, eb, num_rows, num_cols,
                    float(nnz) / max(nc * eb, 1), dev)


def _v1_plan(edges, rb_ids, ct_ids, chunk_starts, rb, ct, eb, num_rows,
             num_cols, fill, dev) -> TiledPlan:
    """The TiledPlan of the host arrays on ``dev``, with K10's schedule."""
    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    nc = int(edges.shape[0])
    plan = TiledPlan(edges=i32(edges), rb_ids=i32(rb_ids),
                     ct_ids=i32(ct_ids), chunk_starts=i32(chunk_starts),
                     rb=rb, ct=ct, eb=eb, nc=nc, num_rows=num_rows,
                     num_cols=num_cols, fill=fill)
    with profiling.stage("plan.sched", kind="v1") as st:
        plan = dataclasses.replace(plan, sched=derive_row_schedule(plan))
    _log.info("v1 schedule: %d real slots of %d in %d segments; derived in "
              "%.3fs", plan.sched.order.shape[0], nc * eb, plan.sched.nseg,
              st.seconds)
    return plan


def derive_row_schedule(plan: TiledPlan,
                        seg_slots: int = SEG_SLOTS) -> RowSchedule:
    """K10's schedule of ``plan``, from ``edges`` and ``rb_ids`` alone, on
    the plan's device."""
    if plan.nc * plan.eb >= 2**31:
        raise ValueError(f"{plan.nc * plan.eb} slots: K10's int32 slot "
                         "index overflows")
    e = plan.edges.reshape(plan.nc, 3, plan.eb)
    real = torch.nonzero(e[:, 2].reshape(-1).view(torch.float32) != 0
                         ).reshape(-1)
    row = (plan.rb_ids.long()[:, None] * plan.rb
           + e[:, 0].long()).reshape(-1)[real]
    return RowSchedule(**row_items(row, real, plan.num_rows, seg_slots))


SumPlan = Union[HybridPlan, HybridPlanV3, TiledPlanV2, TiledPlan]


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """A CSRGraph with the sum plans of A (``fwd``) and Aᵀ (``bwd``, or
    None) of one version, and the segment work lists of A (``fwd_mm``) and
    Aᵀ (``bwd_mm``)."""

    graph: CSRGraph
    fwd: SumPlan
    bwd: Optional[SumPlan]
    fwd_mm: MinMaxPlan
    bwd_mm: MinMaxPlan

    @property
    def num_rows(self) -> int:
        return self.graph.num_rows

    @property
    def num_cols(self) -> int:
        return self.graph.num_cols

    @property
    def nnz(self) -> int:
        return self.graph.nnz

    @property
    def nnz_padded(self) -> int:
        return self.graph.nnz_padded

    @property
    def shape(self):
        return self.graph.shape

    @property
    def device(self):
        return self.graph.device


def base_graph(g) -> CSRGraph:
    return g.graph if isinstance(g, TiledGraph) else g


def _check_plan_keys(version: int, plan_kwargs: dict) -> None:
    if version not in PLAN_KEYS:
        raise ValueError(f"version must be one of {sorted(PLAN_KEYS)}, got "
                         f"{version!r}")
    foreign = sorted(set(plan_kwargs) - set(PLAN_KEYS[version]))
    if foreign:
        raise ValueError(
            f"plan version {version} takes {list(PLAN_KEYS[version])}, got "
            f"{foreign}")


def _build_fn(version: int, k: int, plan_kwargs: dict, dev):
    """``build(row, col, val, num_rows, num_cols)`` of one version."""
    kw = dict(plan_kwargs)
    if version <= 3:  # the JAX package's build_tiling defaults
        kw = {**_GEOMETRY, **kw}

    def build(row, col, val, num_rows, num_cols):
        if version in (5, 4):
            # version 4: no block can hold more edges than the graph
            thr = (kw.get("dense_threshold", 64) if version == 5
                   else row.shape[0] + 1)
            return build_hybrid_plan(row, col, val, num_rows, num_cols, dev,
                                     dense_threshold=thr)
        if version == 3:
            return build_plan_v3_arrays(row, col, val, num_rows, num_cols,
                                        k=k, device=dev, **kw)
        if version == 2:
            return build_plan_v2_arrays(row, col, val, num_rows, num_cols,
                                        k=k, device=dev, **kw)
        return build_plan_v1_arrays(row, col, val, num_rows, num_cols,
                                    device=dev, **kw)

    return build


def build_tiling_from_numpy(graph: CSRGraph, arrays: dict, version: int = 5,
                            k: int = 32, build_backward: bool = True,
                            cache_tag: Optional[str] = None,
                            cache_dir: Optional[str] = None,
                            **plan_kwargs) -> TiledGraph:
    """Attach the plans of A and Aᵀ of ``version``, built from the host
    arrays of ``graph._build_arrays`` on the graph's device, and the segment
    work lists of A (from ``arrays["rowptr"]``, with K3's schedule) and Aᵀ
    (from ``arrays["csc_colptr"]``).

    ``plan_kwargs`` are the keys of ``PLAN_KEYS[version]``; any other key
    raises ``ValueError``.  ``k``, the expected feature width, sizes the v2
    and v3 plans' superblocks.  ``cache_tag`` persists the built plans under
    that graph tag, or loads them when they are there
    (:mod:`isplib_tpu_torch.sparse.plan_cache`).

    The call is a ``plan.build`` stage (``utils.profiling``); each
    direction's sum plan is a stage ``plan.v<version>`` and each segment
    work list a ``plan.mm``.
    """
    with _plan_stage(version, k, plan_kwargs) as st:
        tiled, st.attrs["cached"] = _build_from_numpy(
            graph, arrays, version, k, build_backward, cache_tag, cache_dir,
            plan_kwargs)
    return tiled


def _build_from_numpy(graph: CSRGraph, arrays: dict, version: int, k: int,
                      build_backward: bool, cache_tag: Optional[str],
                      cache_dir: Optional[str], plan_kwargs: dict):
    """The body of :func:`build_tiling_from_numpy`: the tiled graph, and
    whether its plans came from the plan cache."""
    _check_plan_keys(version, plan_kwargs)
    nnz = graph.nnz
    plans = cache_path = None
    if cache_tag is not None:
        from .plan_cache import load_host_plans, tree_to
        cache_path = _cache_path(graph, arrays, version, k, build_backward,
                                 cache_tag, cache_dir, plan_kwargs)
        plans = load_host_plans(cache_path)
        if plans is not None:
            plans = tree_to(plans, graph.device)
    cached = plans is not None
    if plans is None:
        build = _build_fn(version, k, plan_kwargs, graph.device)
        fwd, t_fwd = _sum_plan(
            build, version, "A", arrays["row"][:nnz], arrays["col"][:nnz],
            arrays["value"][:nnz], graph.num_rows, graph.num_cols)
        bwd, t_bwd = _sum_plan(
            build, version, "AT", arrays["csc_row"][:nnz],
            arrays["csc_col"][:nnz], arrays["csc_value"][:nnz],
            graph.num_cols, graph.num_rows) if build_backward else (None, 0.0)
        _log.info("version %d plan of A built in %.3fs, of Aᵀ in %.3fs",
                  version, t_fwd, t_bwd)
        with profiling.stage("plan.mm", direction="A", schedule=True):
            fwd_mm = build_minmax_plan(arrays["rowptr"], graph.num_rows,
                                       graph.num_cols, graph.device,
                                       schedule=True)
        with profiling.stage("plan.mm", direction="AT", schedule=False):
            bwd_mm = build_minmax_plan(arrays["csc_colptr"], graph.num_cols,
                                       graph.num_rows, graph.device)
        plans = dict(fwd=fwd, bwd=bwd, fwd_mm=fwd_mm, bwd_mm=bwd_mm)
        if cache_path is not None:
            from .plan_cache import save_host_plans
            save_host_plans(cache_path, plans)
    return TiledGraph(graph=graph, **plans), cached


def _plan_stage(version: int, k: int, plan_kwargs: dict):
    """A ``plan.build`` stage of this version and configuration."""
    return profiling.stage("plan.build", version=version, k=k,
                           cfg=dict(plan_kwargs))


def _sum_plan(build, version: int, direction: str, row, col, val,
              num_rows: int, num_cols: int):
    """One direction's sum plan as the stage ``plan.v<version>``, and its
    seconds."""
    with profiling.stage(f"plan.v{version}", direction=direction) as st:
        plan = build(row, col, val, num_rows, num_cols)
        if isinstance(plan, HybridPlan):
            st.attrs.update(blocks=plan.nb, dense_edges=plan.dense_edges,
                            residual_edges=plan.sparse_edges)
    return plan, st.seconds


def _cache_path(graph, arrays, version, k, build_backward, cache_tag,
                cache_dir, plan_kwargs) -> str:
    from .plan_cache import graph_fingerprint, plan_cache_path
    nnz = graph.nnz
    cfg = dict(version=version, k=k, bwd=build_backward,
               fp=graph_fingerprint(arrays, nnz), nnz=nnz,
               shape=list(graph.shape), **plan_kwargs)
    return plan_cache_path(cache_tag, cfg, cache_dir)


def save_tiling(tiled: TiledGraph, arrays: dict, version: int, k: int,
                cache_tag: str, cache_dir: Optional[str] = None,
                **plan_kwargs) -> None:
    """Persist the plans of ``tiled``, built by ``build_tiling_from_numpy(
    tiled.graph, arrays, version, k, **plan_kwargs)``, where that call with
    ``cache_tag`` would have put them, so that it loads them from now on."""
    from .plan_cache import save_host_plans
    _check_plan_keys(version, plan_kwargs)
    save_host_plans(
        _cache_path(tiled.graph, arrays, version, k, tiled.bwd is not None,
                    cache_tag, cache_dir, plan_kwargs),
        dict(fwd=tiled.fwd, bwd=tiled.bwd, fwd_mm=tiled.fwd_mm,
             bwd_mm=tiled.bwd_mm))


def host_arrays(graph: CSRGraph) -> dict:
    """The graph's edge arrays read back to the host, as numpy (a
    ``plan.readback`` stage); values that need a gradient are read as they
    stand."""
    fields = ("rowptr", "row", "col", "value", "csc_colptr", "csc_row",
              "csc_col", "csc_value")
    with profiling.stage("plan.readback", bytes=sum(
            getattr(graph, f).nbytes for f in fields)):
        return {f: getattr(graph, f).detach().cpu().numpy() for f in fields}


def build_tiling(graph: CSRGraph, version: int = 5, k: int = 32,
                 build_backward: bool = True,
                 cache_tag: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 **plan_kwargs) -> TiledGraph:
    """Attach the plans, reading the graph's edge arrays back to the host
    (arguments as :func:`build_tiling_from_numpy`); the read back and the
    build are one ``plan.build`` stage."""
    with _plan_stage(version, k, plan_kwargs) as st:
        tiled, st.attrs["cached"] = _build_from_numpy(
            graph, host_arrays(graph), version, k, build_backward, cache_tag,
            cache_dir, plan_kwargs)
    return tiled


# auto_tile's memo, per graph identity: the plan key of each K bucket, and
# per plan key the plans and a weak reference to the TiledGraph last made of
# them.  It holds no reference to the graph, so an entry goes when its graph
# is collected.
_AUTO_TILED: dict = {}
_PLAN_FIELDS = ("fwd", "bwd", "fwd_mm", "bwd_mm")


def _k_bucket(k: int) -> int:
    return min(((max(k, 1) + 31) // 32) * 32, 256)


def _on_cuda(graph: CSRGraph) -> bool:
    return graph.device.type == "cuda"


def auto_tile(graph, k: int = 32):
    """Tile a large CSRGraph on CUDA; return anything else unchanged.

    The tune cache (:mod:`isplib_tpu_torch.tune`) decides first: a
    ``"reference"`` entry for the graph's signature at ``k`` leaves the
    graph as it is, a ``"kernels"`` entry builds its version and
    configuration through the plan cache under the signature, so that the
    plans ``tune_spmm`` persisted are loaded, not built.  Without an entry
    the dense threshold follows the JAX package's occupancy rule: version 5
    at 64 when the graph averages at least 200 edges per 128×128 block,
    else at 128, built on the device and not cached (a v5 build on the
    card is faster than reading its plans back from disk).  The choice is
    kept per (graph, K bucket), and its plans per (graph, version,
    configuration): K buckets that choose the same plans of a version
    other than 2 and 3 (which size theirs by ``k``) share one build.  The
    plans hold the values the graph had when it was tiled.
    A CPU graph is never tiled: there the plan would run the kernels' plain
    versions, which the reference path beats.
    """
    if (not isinstance(graph, CSRGraph) or graph.nnz < AUTO_TILE_MIN_NNZ
            or not _on_cuda(graph)):
        return graph
    memo = _AUTO_TILED.get(id(graph))
    if memo is None:
        memo = _AUTO_TILED[id(graph)] = dict(buckets={}, plans={})
        weakref.finalize(graph, _AUTO_TILED.pop, id(graph), None)
    bucket = _k_bucket(k)
    plan_key = memo["buckets"].get(bucket)
    if plan_key is None:
        from ..tune import autotune
        signature = autotune.signature_of(graph, k)
        entry = autotune.lookup(signature)
        if entry and entry.get("backend") == "reference":
            return graph  # measured: the reference path wins on this graph
        if entry and entry.get("backend") == "kernels":
            version = int(entry["version"])
            cfg = {f: entry[f] for f in PLAN_KEYS[version] if f in entry}
            cache_tag = signature
        else:
            occ = graph.nnz / max(
                _cdiv(graph.num_rows, 128) * _cdiv(graph.num_cols, 128), 1)
            version = 5
            cfg = dict(dense_threshold=64 if occ >= 200 else 128)
            cache_tag = None
        # only versions 2 and 3 size their plans by k: the others' serve
        # every K bucket
        plan_key = (version, tuple(sorted(cfg.items())),
                    bucket if version in (2, 3) else None)
        if plan_key not in memo["plans"]:
            _log.info("auto-tiling graph (%d edges) with version %d %s",
                      graph.nnz, version, cfg)
            tiled = build_tiling(graph, version=version, k=k,
                                 cache_tag=cache_tag, **cfg)
            memo["plans"][plan_key] = [
                {f: getattr(tiled, f) for f in _PLAN_FIELDS},
                weakref.ref(tiled)]
        memo["buckets"][bucket] = plan_key
    held = memo["plans"][plan_key]
    tiled = held[1]()
    if tiled is None:
        tiled = TiledGraph(graph=graph, **held[0])
        held[1] = weakref.ref(tiled)
    return tiled
