"""The plain 2-layer GCN (Kipf & Welling, arXiv:1609.02907; the reference's
``tests/cpu/gcn-sparse.py``): forward, masked NLL and gradients written out
in plain PyTorch, float32.

  Â  = D^-1/2 (A + I) D^-1/2, a self loop added to each node without one
       (PyG ``gcn_norm``), D the row sums of A + I
  h  = dropout(relu(Â (x W1) + b1))
  lp = log_softmax(Â (h W2) + b2)

Â and Âᵀ are built here from the edge list, as the port's ``nn.gcn_norm``
builds its graph, but from nothing the port made.
"""

from __future__ import annotations

import torch

from .plain import FP32, Adjacency, Precision, dropout, lane_fault, \
    masked_nll, mm


def parameters(cfg: dict, num_features: int, num_classes: int):
    """The layout of the port's ``nn.models.GCN`` state_dict, with the law
    each tensor is drawn from (its initialiser's)."""
    h = cfg["hidden"]
    return [("conv1.kernel", (num_features, h), "glorot_uniform"),
            ("conv1.bias", (h,), "zeros"),
            ("conv2.kernel", (h, num_classes), "glorot_uniform"),
            ("conv2.bias", (num_classes,), "zeros")]


def normalized(edge_index: torch.Tensor, n: int):
    """(row, col, value) of Â for the edge list ``[src; dst]`` (entry
    (dst, src)), values in float32 from float64 degrees."""
    src, dst = edge_index[0], edge_index[1]
    has = torch.zeros(n, dtype=torch.bool, device=src.device)
    has[dst[src == dst]] = True
    loops = torch.nonzero(~has)[:, 0]
    row = torch.cat([dst, loops])
    col = torch.cat([src, loops])
    deg = torch.bincount(row, minlength=n).double()
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    return row, col, (dinv[row] * dinv[col]).float()


class Model:
    def __init__(self, edge_index: torch.Tensor, n: int, x: torch.Tensor,
                 y: torch.Tensor, cfg: dict):
        row, col, val = normalized(edge_index, n)
        self.a = Adjacency(row, col, val, n, n)
        self.at = Adjacency(col, row, val, n, n)
        self.x, self.y = x, y

    def _agg(self, adj: Adjacency, t: torch.Tensor, prec: Precision,
             fault: str | None) -> torch.Tensor:
        out = adj.sum(t, prec.aggregation)
        return lane_fault(out) if fault == "lane" else out

    def loss_and_grads(self, p: dict, keep_mask: torch.Tensor, keep: float,
                       train: torch.Tensor, prec: Precision = FP32,
                       fault: str | None = None):
        w1, b1 = p["conv1.kernel"], p["conv1.bias"]
        w2, b2 = p["conv2.kernel"], p["conv2.bias"]
        a1 = self._agg(self.a, mm(self.x, w1, prec), prec, fault) + b1
        h = dropout(torch.relu(a1), keep_mask, keep)
        a2 = self._agg(self.a, mm(h, w2, prec), prec, fault) + b2
        loss, g2 = masked_nll(a2, self.y, train)
        gz2 = self._agg(self.at, g2, prec, fault)
        gh = mm(gz2, w2.T, prec)
        g1 = dropout(gh, keep_mask, keep) * (a1 > 0)
        gz1 = self._agg(self.at, g1, prec, fault)
        grads = {"conv1.kernel": mm(self.x.T, gz1, prec),
                 "conv1.bias": g1.sum(0),
                 "conv2.kernel": mm(h.T, gz2, prec),
                 "conv2.bias": g2.sum(0)}
        return loss, grads
