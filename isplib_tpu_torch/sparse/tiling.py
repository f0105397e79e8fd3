"""A graph with its SpMM plans, the counterpart of ``isplib_tpu.sparse.tiling``
(v5 hybrid plans, the max/min plan, and the with-eids and v4 plans that the
JAX package's SDDMM and FusedMM kernels walk).

``fwd`` drives sum/mean ``spmm(A, x)`` and ``bwd`` is the plan of Aᵀ, built
from the CSC arrays, for ``grad_x = spmm(Aᵀ, g)``.  The backward never runs
the forward plan: that would compute ``spmm(A, g)``.  ``fwd_mm`` is a segment
work list over the CSR: it drives max/min ``spmm(A, x)`` with the winning
edge ids, the SDDMM (K4), the FusedMM forward (K5) and its ``grad_x`` pass
(K6 pass A).  ``bwd_mm`` is the same list over the CSC, the rows of Aᵀ: the
FusedMM ``grad_y`` pass (K6 pass B) walks it.

The JAX package runs its FusedMM kernel only on a ``version=4`` tiling and
its SDDMM kernel only on a tiling with the with-eids v2 plan.  The port has
one ``TiledGraph``, which carries every list these kernels read, and no
``version`` argument; the functions computed are the same.  An edge's CSR
position is its id, so the SDDMM writes in CSR order with no ``eid_pos``
scatter.
"""

from __future__ import annotations

import dataclasses

from .graph import CSRGraph
from .tiling_v4mm import MinMaxPlan, build_minmax_plan
from .tiling_v5 import HybridPlan, build_hybrid_plan

__all__ = ["TiledGraph", "build_tiling", "build_tiling_from_numpy",
           "auto_tile", "base_graph", "AUTO_TILE_MIN_NNZ"]

# Below this edge count the reference path is fast enough and the plan
# build would dominate (the JAX package's threshold).
AUTO_TILE_MIN_NNZ = 1_000_000


@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """A CSRGraph with the hybrid plans of A (``fwd``) and Aᵀ (``bwd``) and
    the segment work lists of A (``fwd_mm``) and Aᵀ (``bwd_mm``)."""

    graph: CSRGraph
    fwd: HybridPlan
    bwd: HybridPlan
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


def build_tiling_from_numpy(graph: CSRGraph, arrays: dict,
                            dense_threshold: int = 64) -> TiledGraph:
    """Attach the plans of A and Aᵀ, built from the host arrays of
    ``graph._build_arrays``, on the graph's device, and the segment work
    lists of A (from ``arrays["rowptr"]``) and Aᵀ (from
    ``arrays["csc_colptr"]``): a few MB each, always built, as the JAX
    package's ``auto_tile`` builds its max/min plan, so max/min, SDDMM and
    FusedMM on a tiled graph run their kernels."""
    nnz = graph.nnz
    fwd = build_hybrid_plan(
        arrays["row"][:nnz], arrays["col"][:nnz], arrays["value"][:nnz],
        graph.num_rows, graph.num_cols, graph.device,
        dense_threshold=dense_threshold)
    bwd = build_hybrid_plan(
        arrays["csc_row"][:nnz], arrays["csc_col"][:nnz],
        arrays["csc_value"][:nnz], graph.num_cols, graph.num_rows,
        graph.device, dense_threshold=dense_threshold)
    fwd_mm = build_minmax_plan(arrays["rowptr"], graph.num_rows,
                               graph.num_cols, graph.device)
    bwd_mm = build_minmax_plan(arrays["csc_colptr"], graph.num_cols,
                               graph.num_rows, graph.device)
    return TiledGraph(graph=graph, fwd=fwd, bwd=bwd, fwd_mm=fwd_mm,
                      bwd_mm=bwd_mm)


def build_tiling(graph: CSRGraph, dense_threshold: int = 64) -> TiledGraph:
    """Attach the plans, reading the graph's edge arrays back to the host."""
    arrays = {f: getattr(graph, f).cpu().numpy()
              for f in ("rowptr", "row", "col", "value", "csc_colptr",
                        "csc_row", "csc_col", "csc_value")}
    return build_tiling_from_numpy(graph, arrays, dense_threshold)


def auto_tile(graph):
    """Tile a large CSRGraph on CUDA; return anything else unchanged.

    The dense threshold follows the JAX package's occupancy rule: 64 when
    the graph averages at least 200 edges per 128×128 block, else 128.  A
    CPU graph is never tiled: there the plan would run the kernels' plain
    versions, which the reference path beats.
    """
    if (not isinstance(graph, CSRGraph) or graph.nnz < AUTO_TILE_MIN_NNZ
            or graph.device.type != "cuda"):
        return graph
    occ = graph.nnz / max(
        (-(-graph.num_rows // 128)) * (-(-graph.num_cols // 128)), 1)
    return build_tiling(graph, dense_threshold=64 if occ >= 200 else 128)
