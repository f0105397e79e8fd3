"""Model zoo, the counterpart of ``isplib_tpu.nn.models`` (``GCN``,
``GraphSAGE``, ``GIN`` and ``MODEL_REGISTRY``), and ``GAT``, which the
JAX package lacks.

Unlike flax, a torch module needs its input width up front.  Weights are
drawn from ``seed`` on the CPU, so every device gets the same model.  Every
model takes ``generator`` (on x's device) for its dropout mask in training
mode; without one the global generator draws it.  The graph and
``backend`` (passed to every SpMM, ``ops.spmm.spmm``) pick the SpMM path:
a TiledGraph runs the kernels, a CSRGraph the reference unless
``auto_tile`` tiles it (a large one on CUDA); ``backend="reference"`` runs
the reference on every graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import BatchNorm, Dense, GATConv, GCNConv, GINConv, SAGEConv

__all__ = ["GCN", "GraphSAGE", "GIN", "GAT", "MODEL_REGISTRY"]


def _dropout(h: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if not training or rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


class GCN(nn.Module):
    """2-layer GCN → log_softmax (the reference's gcn-sparse.py model)."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_classes: int = 41, dropout_rate: float = 0.5,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dropout_rate = dropout_rate
        self.conv1 = GCNConv(in_features, hidden, device, gen)
        self.conv2 = GCNConv(hidden, num_classes, device, gen)

    def forward(self, graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                backend: Optional[str] = None) -> torch.Tensor:
        h = F.relu(self.conv1(graph, x, backend))
        h = _dropout(h, self.dropout_rate, self.training, generator)
        return F.log_softmax(self.conv2(graph, h, backend), dim=-1)


class GraphSAGE(nn.Module):
    """2-layer GraphSAGE with sum|mean|max|min aggregation → log_softmax
    (the reference's graphSAGE-sparse.py model)."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_classes: int = 41, aggr: str = "mean",
                 dropout_rate: float = 0.5,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dropout_rate = dropout_rate
        self.conv1 = SAGEConv(in_features, hidden, aggr, device, gen)
        self.conv2 = SAGEConv(hidden, num_classes, aggr, device, gen)

    def forward(self, graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                backend: Optional[str] = None) -> torch.Tensor:
        h = F.relu(self.conv1(graph, x, backend))
        h = _dropout(h, self.dropout_rate, self.training, generator)
        return F.log_softmax(self.conv2(graph, h, backend), dim=-1)


class _GINMLP(nn.Module):
    """Dense → relu → Dense (flax ``_GINMLP``)."""

    def __init__(self, in_features: int, width: int, out: int,
                 device: str | torch.device, generator: torch.Generator):
        super().__init__()
        self.dense_0 = Dense(in_features, width, True, device, generator)
        self.dense_1 = Dense(width, out, True, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(F.relu(self.dense_0(x)))


class GIN(nn.Module):
    """2 GIN convs (2-layer MLPs) + batchnorm + 2 FC heads, logits output
    (trained with cross-entropy; the reference's gin-sparse.py model)."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_classes: int = 41, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = GINConv(_GINMLP(in_features, hidden, hidden, device,
                                     gen))
        self.bn1 = BatchNorm(hidden, device=device)
        self.conv2 = GINConv(_GINMLP(hidden, hidden, hidden, device, gen))
        self.bn2 = BatchNorm(hidden, device=device)
        self.fc1 = Dense(hidden, hidden, True, device, gen)
        self.fc2 = Dense(hidden, num_classes, True, device, gen)

    def forward(self, graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                backend: Optional[str] = None) -> torch.Tensor:
        h = self.bn1(self.conv1(graph, x, backend))
        h = self.bn2(self.conv2(graph, h, backend))
        return self.fc2(F.relu(self.fc1(h)))


class GAT(nn.Module):
    """The 3-layer GAT of Veličković et al. (arXiv:1710.10903) at its PPI
    configuration → log_softmax: ``GATConv(in, hidden, heads[0])``
    concatenated, ELU; ``GATConv(heads[0]·hidden, hidden, heads[1])``
    concatenated, plus the identity skip across it, ELU;
    ``GATConv(heads[1]·hidden, classes, heads[2])`` averaged.  No dropout
    (``generator`` is not read); LeakyReLU's slope 0.2 (``GATConv``'s
    default); the self loops are the attention's own."""

    def __init__(self, in_features: int, hidden: int = 256,
                 num_classes: int = 41, heads=(4, 4, 6),
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        h1, h2, h3 = heads
        if h1 != h2:
            raise ValueError("the skip across layer 2 needs heads[0] == "
                             "heads[1]")
        self.conv1 = GATConv(in_features, hidden, h1, True, device=device,
                             generator=gen)
        self.conv2 = GATConv(h1 * hidden, hidden, h2, True, device=device,
                             generator=gen)
        self.conv3 = GATConv(h2 * hidden, num_classes, h3, False,
                             device=device, generator=gen)

    def forward(self, graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                backend: Optional[str] = None) -> torch.Tensor:
        h = F.elu(self.conv1(graph, x, backend))
        h = F.elu(self.conv2(graph, h, backend) + h)
        return F.log_softmax(self.conv3(graph, h, backend), dim=-1)


MODEL_REGISTRY = {
    "gcn": GCN,
    "sage": GraphSAGE,
    "gin": GIN,
    "gat": GAT,
}
