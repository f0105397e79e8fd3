"""isplib_tpu_torch — the PyTorch/CUDA port of isplib_tpu for NVIDIA Hopper.

Sparse GNN message passing: padded CSR graphs with a CSC view, SpMM with
autograd over all four reductions, the GCN, GraphSAGE and GIN models and the
reference training protocol.  On a tiled graph, sum/mean SpMM runs two
hand-written CUDA kernels and max/min SpMM a third (``kernels/csrc``); the
JAX package ``isplib_tpu`` beside this one is the unchanged reference.
Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.
"""

from .convert import (gcn_params_from_flax, gin_params_from_flax,
                      sage_params_from_flax)
from .ops import Reduce, SpMM, spmm
from .sparse import (CSRGraph, TiledGraph, auto_tile, build_tiling,
                     build_tiling_from_numpy, from_edge_index, from_scipy,
                     graph_from_arrays)
from .nn import (GCN, GIN, MODEL_REGISTRY, GCNConv, GINConv, GraphSAGE,
                 SAGEConv, add_self_loops, gcn_norm, row_normalize)
from .train import TrainResult, train_node_classifier

__version__ = "0.2.0"

__all__ = [
    "CSRGraph", "TiledGraph", "from_edge_index", "from_scipy",
    "graph_from_arrays", "build_tiling", "build_tiling_from_numpy",
    "auto_tile", "Reduce", "SpMM", "spmm", "GCN", "GraphSAGE", "GIN",
    "MODEL_REGISTRY", "GCNConv", "SAGEConv", "GINConv", "add_self_loops",
    "gcn_norm", "row_normalize", "TrainResult", "train_node_classifier",
    "gcn_params_from_flax", "sage_params_from_flax", "gin_params_from_flax",
    "__version__",
]
