from .loaders import (DATASET_STATS, REAL_BUILTIN, get_padding_size, load,
                      load_mtx, pad_features)
from .synthetic import (NodeDataset, gen_gcnsig_graph, gen_rmat_graph,
                        rmat_dataset, rmat_edges, sbm_dataset)

__all__ = ["NodeDataset", "gen_gcnsig_graph", "gen_rmat_graph",
           "rmat_dataset", "rmat_edges", "sbm_dataset", "DATASET_STATS",
           "REAL_BUILTIN", "get_padding_size", "load", "load_mtx",
           "pad_features"]
