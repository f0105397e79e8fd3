from .graph import CSRGraph, from_edge_index, from_scipy, graph_from_arrays
from .tiling import (AUTO_TILE_MIN_NNZ, TiledGraph, auto_tile, base_graph,
                     build_tiling, build_tiling_from_numpy)
from .tiling_v4mm import MinMaxPlan, build_minmax_plan
from .tiling_v5 import HybridPlan, build_hybrid_plan

__all__ = ["CSRGraph", "from_edge_index", "from_scipy", "graph_from_arrays",
           "AUTO_TILE_MIN_NNZ", "TiledGraph", "auto_tile",
           "base_graph", "build_tiling", "build_tiling_from_numpy",
           "HybridPlan", "build_hybrid_plan", "MinMaxPlan",
           "build_minmax_plan"]
