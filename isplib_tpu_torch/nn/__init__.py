from .conv import BatchNorm, Dense, GCNConv, GINConv, SAGEConv
from .models import GCN, GIN, MODEL_REGISTRY, GraphSAGE
from .transforms import add_self_loops, gcn_norm, row_normalize

__all__ = ["Dense", "BatchNorm", "GCNConv", "SAGEConv", "GINConv", "GCN",
           "GraphSAGE", "GIN", "MODEL_REGISTRY", "add_self_loops",
           "gcn_norm", "row_normalize"]
