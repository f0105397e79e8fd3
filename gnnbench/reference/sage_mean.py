"""The plain 2-layer GraphSAGE with mean aggregation (Hamilton et al.,
arXiv:1706.02216; the reference's ``graphSAGE-sparse.py``): forward,
masked NLL and gradients written out in plain PyTorch, float32.

  mean(x)[r] = (Σ over the entries (r, c) of x[c]) / max(deg r, 1)
  h  = dropout(relu((mean(x) Wl1 + bl1) + x Wr1))
  lp = log_softmax((mean(h) Wl2 + bl2) + h Wr2)

deg counts a row's entries, duplicate edges too, as PyG's mean
aggregation does; a row without any reads 0.  The gradient of a mean in
its input is Aᵀ (g / max(deg, 1)).  The first layer's aggregation reads
only the input features, so it is the same in every step and is computed
once for each precision its operands take.
"""

from __future__ import annotations

import torch

from .plain import FP32, Adjacency, Precision, dropout, lane_fault, \
    masked_nll, mm
from .sage_max import parameters  # the same state_dict as GraphSAGE-max

__all__ = ["Model", "parameters"]


class Model:
    def __init__(self, edge_index: torch.Tensor, n: int, x: torch.Tensor,
                 y: torch.Tensor, cfg: dict):
        self.a = Adjacency(edge_index[1], edge_index[0], None, n, n)
        self.at = Adjacency(edge_index[0], edge_index[1], None, n, n)
        self.deg = self.a.deg.clamp(min=1).to(x.dtype)[:, None]
        self.x, self.y = x, y
        self.agg_x = {}

    def mean(self, t: torch.Tensor, fmt: str) -> torch.Tensor:
        return self.a.sum(t, fmt) / self.deg

    def loss_and_grads(self, p: dict, keep_mask: torch.Tensor, keep: float,
                       train: torch.Tensor, prec: Precision = FP32,
                       fault: str | None = None):
        fmt = prec.aggregation
        if fmt not in self.agg_x:
            self.agg_x[fmt] = self.mean(self.x, fmt)
        agg1 = self.agg_x[fmt]
        if fault == "lane":
            agg1 = lane_fault(agg1)
        a1 = (mm(agg1, p["conv1.lin_l.kernel"], prec) + p["conv1.lin_l.bias"]
              + mm(self.x, p["conv1.lin_r.kernel"], prec))
        h = dropout(torch.relu(a1), keep_mask, keep)
        agg2 = self.mean(h, fmt)
        if fault == "lane":
            agg2 = lane_fault(agg2)
        wl2, wr2 = p["conv2.lin_l.kernel"], p["conv2.lin_r.kernel"]
        a2 = mm(agg2, wl2, prec) + p["conv2.lin_l.bias"] + mm(h, wr2, prec)
        loss, g2 = masked_nll(a2, self.y, train)
        g_agg2 = mm(g2, wl2.T, prec) / self.deg
        gh = mm(g2, wr2.T, prec) + self.at.sum(g_agg2, fmt)
        g1 = dropout(gh, keep_mask, keep) * (a1 > 0)
        grads = {"conv1.lin_l.kernel": mm(agg1.T, g1, prec),
                 "conv1.lin_l.bias": g1.sum(0),
                 "conv1.lin_r.kernel": mm(self.x.T, g1, prec),
                 "conv2.lin_l.kernel": mm(agg2.T, g2, prec),
                 "conv2.lin_l.bias": g2.sum(0),
                 "conv2.lin_r.kernel": mm(h.T, g2, prec)}
        return loss, grads
