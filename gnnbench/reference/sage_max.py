"""The plain 2-layer GraphSAGE with max aggregation (Hamilton et al.,
arXiv:1706.02216; the reference's ``graphSAGE-sparse.py``): forward,
masked NLL and gradients written out in plain PyTorch, float32.

  agg(x)[r] = max over the neighbours c of r of x[c] (0 without any)
  h  = dropout(relu((agg(x) Wl1 + bl1) + x Wr1))
  lp = log_softmax((agg(h) Wl2 + bl2) + h Wr2)

The gradient of a max goes to the winning neighbour, the lowest column
among ties, which is the port's lowest edge id in its CSR order.  The
first layer's aggregation reads only the input features, so it is the
same in every step and is computed once.
"""

from __future__ import annotations

import torch

from .plain import FP32, Adjacency, Precision, dropout, lane_fault, \
    masked_nll, mm, route_max


def parameters(cfg: dict, num_features: int, num_classes: int):
    """The layout of the port's ``nn.models.GraphSAGE`` state_dict, with
    the law each tensor is drawn from (its initialiser's)."""
    h = cfg["hidden"]
    return [("conv1.lin_l.kernel", (num_features, h), "lecun_normal"),
            ("conv1.lin_l.bias", (h,), "zeros"),
            ("conv1.lin_r.kernel", (num_features, h), "lecun_normal"),
            ("conv2.lin_l.kernel", (h, num_classes), "lecun_normal"),
            ("conv2.lin_l.bias", (num_classes,), "zeros"),
            ("conv2.lin_r.kernel", (h, num_classes), "lecun_normal")]


class Model:
    def __init__(self, edge_index: torch.Tensor, n: int, x: torch.Tensor,
                 y: torch.Tensor, cfg: dict):
        self.a = Adjacency(edge_index[1], edge_index[0], None, n, n)
        self.x, self.y, self.n = x, y, n
        self.agg_x = self.a.max(x)[0]

    def loss_and_grads(self, p: dict, keep_mask: torch.Tensor, keep: float,
                       train: torch.Tensor, prec: Precision = FP32,
                       fault: str | None = None):
        agg1 = lane_fault(self.agg_x) if fault == "lane" else self.agg_x
        a1 = (mm(agg1, p["conv1.lin_l.kernel"], prec) + p["conv1.lin_l.bias"]
              + mm(self.x, p["conv1.lin_r.kernel"], prec))
        h = dropout(torch.relu(a1), keep_mask, keep)
        agg2, arg2 = self.a.max(h)
        if fault == "lane":
            agg2 = lane_fault(agg2)
        wl2, wr2 = p["conv2.lin_l.kernel"], p["conv2.lin_r.kernel"]
        a2 = mm(agg2, wl2, prec) + p["conv2.lin_l.bias"] + mm(h, wr2, prec)
        loss, g2 = masked_nll(a2, self.y, train)
        gh = mm(g2, wr2.T, prec) + route_max(mm(g2, wl2.T, prec), arg2,
                                              self.n)
        g1 = dropout(gh, keep_mask, keep) * (a1 > 0)
        grads = {"conv1.lin_l.kernel": mm(agg1.T, g1, prec),
                 "conv1.lin_l.bias": g1.sum(0),
                 "conv1.lin_r.kernel": mm(self.x.T, g1, prec),
                 "conv2.lin_l.kernel": mm(agg2.T, g2, prec),
                 "conv2.lin_l.bias": g2.sum(0),
                 "conv2.lin_r.kernel": mm(h.T, g2, prec)}
        return loss, grads
