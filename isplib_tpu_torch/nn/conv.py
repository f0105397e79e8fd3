"""Message-passing layers, the counterpart of ``isplib_tpu.nn.conv``
(``GCNConv``, ``SAGEConv``, ``GINConv``) plus the flax ``Dense`` and
``BatchNorm`` they and the models are built from.

Parameters keep the flax names and shapes (``kernel`` is (in, out)), so a
flax parameter tree maps 1:1 (``isplib_tpu_torch.convert``).  Every layer
takes an explicit ``torch.Generator`` and draws its initial weights from it
on the CPU, from the flax initialiser's distribution.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.spmm import spmm

__all__ = ["Dense", "BatchNorm", "GCNConv", "SAGEConv", "GINConv"]


def _glorot_uniform(fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    """(fan_in, fan_out) float32 from U(±sqrt(6 / (fan_in + fan_out))), the
    flax default kernel init (drawn on the CPU from ``generator``)."""
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    w = torch.rand(fan_in, fan_out, generator=generator)
    return (w * 2.0 - 1.0) * bound


def _lecun_normal(fan_in: int, fan_out: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(fan_in, fan_out) float32 from flax's ``lecun_normal``: a normal
    truncated at ±2 standard deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(fan_in, fan_out)
    return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator()


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)``, kernel (in, out) from
    ``lecun_normal``, bias zeros."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.kernel = nn.Parameter(_lecun_normal(
            in_features, out_features, _generator(generator)).to(dev))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.kernel
        return out + self.bias if self.bias is not None else out


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the node axis, with flax's semantics (not
    ``torch.nn.BatchNorm1d``'s): in training the batch variance is
    E[x²] − E[x]² clipped at 0 and biased, and the running statistics
    follow ``ra = momentum · ra + (1 − momentum) · batch`` with flax's
    momentum 0.99; in eval mode the running statistics normalise.  The
    statistics are buffers, so ``state_dict`` holds them."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(num_features, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))
        self.register_buffer("mean", torch.zeros(num_features, device=dev))
        self.register_buffer("var", torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.epsilon)
                             * self.scale) + self.bias


class GCNConv(nn.Module):
    """x' = Â · (x W) + b, with Â the graph as given (PyG GCNConv with
    ``normalize=False``; apply ``gcn_norm`` once, offline)."""

    def __init__(self, in_features: int, out_features: int,
                 device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = _generator(generator)
        self.kernel = nn.Parameter(
            _glorot_uniform(in_features, out_features, gen).to(dev))
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev))

    def forward(self, graph, x: torch.Tensor) -> torch.Tensor:
        # dense transform first: the SpMM then runs at the (narrower) output width
        return spmm(graph, x @ self.kernel, reduce="sum") + self.bias


class SAGEConv(nn.Module):
    """x' = lin_l(aggr_{neigh}(x)) + lin_r(x), aggr ∈ sum|mean|max|min.

    The aggregation runs on the raw input, so it is as wide as the input
    (K = 602 in the first layer at the reddit configuration); ``lin_l`` has
    a bias and ``lin_r`` none.
    """

    def __init__(self, in_features: int, out_features: int,
                 aggr: str = "mean", device: str | torch.device = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.aggr = aggr
        self.lin_l = Dense(in_features, out_features, True, device, gen)
        self.lin_r = Dense(in_features, out_features, False, device, gen)

    def forward(self, graph, x: torch.Tensor) -> torch.Tensor:
        agg = spmm(graph, x, reduce=self.aggr)
        return self.lin_l(agg) + self.lin_r(x)


class GINConv(nn.Module):
    """x' = mlp((1 + eps) · x + sum_{neigh}(x)); ``train_eps`` makes eps a
    parameter (PyG's default, which the reference uses, is a fixed 0)."""

    def __init__(self, mlp: nn.Module, eps: float = 0.0,
                 train_eps: bool = False):
        super().__init__()
        self.mlp, self.train_eps = mlp, train_eps
        if train_eps:
            dev = next(mlp.parameters()).device
            self.eps = nn.Parameter(torch.tensor(float(eps), device=dev))
        else:
            self.eps = float(eps)

    def forward(self, graph, x: torch.Tensor) -> torch.Tensor:
        agg = spmm(graph, x, reduce="sum")
        return self.mlp((1.0 + self.eps) * x + agg)
