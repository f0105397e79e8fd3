from .conv import BatchNorm, Dense, GATConv, GCNConv, GINConv, SAGEConv
from .models import GAT, GCN, GIN, MODEL_REGISTRY, GraphSAGE
from .transforms import add_self_loops, gcn_norm, row_normalize

__all__ = ["Dense", "BatchNorm", "GCNConv", "SAGEConv", "GINConv", "GATConv",
           "GCN", "GraphSAGE", "GIN", "GAT", "MODEL_REGISTRY",
           "add_self_loops", "gcn_norm", "row_normalize"]
