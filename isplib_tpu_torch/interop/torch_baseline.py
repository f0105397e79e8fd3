"""The plain-torch baseline, the reference's ``pt1`` column, the counterpart
of ``isplib_tpu.interop.torch_baseline``.

The same GCN, GraphSAGE and GIN nets as the JAX package's baseline, in
plain torch: aggregation through ``torch.sparse.mm`` over a CSR tensor for
sum and mean, and ``scatter_reduce_`` for max and min; Adam (lr 0.01,
weight decay 5e-4), dropout 0.5, NLL (GCN, GraphSAGE) or cross-entropy
(GIN), and the reference's result table.  On a card ``torch.sparse.mm`` is
torch's own (cuSPARSE); under ``interop.iSpLibPlugin.patch_pyg`` it is the
port's kernels: that is the reference's A/B.

The initial weights and the dropout masks come from one ``torch.Generator``
on the device, seeded with ``seed``, drawn in the order in which the JAX
package's baseline draws them from the global generator after
``torch.manual_seed(seed)``; on the CPU that is the same stream, so the two
train the same net.  One warm-up epoch (first-call costs, the bridge's graph
build and tiling under the patch) runs before the timed epochs, and the
parameters, the batch statistics and the generator are restored after it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..sparse.tiling import base_graph
from ..train.loop import TrainResult, _Clock

__all__ = ["train_torch_baseline"]


def _graph_tensors(graph):
    """The CSR tensor of the real edges, the degree vector and the
    (row, col, value) edge lists, on the graph's device."""
    n = graph.nnz
    row, col = graph.row[:n].long(), graph.col[:n].long()
    val = graph.value[:n]
    a = torch.sparse_csr_tensor(graph.rowptr.long(), col, val,
                                size=graph.shape)
    return a, graph.deg, (row, col, val)


def _make_aggr(a, deg, rc, aggr: str):
    if aggr == "sum":
        return lambda x: torch.sparse.mm(a, x)
    if aggr == "mean":
        d = deg.clamp(min=1.0)[:, None]
        return lambda x: torch.sparse.mm(a, x) / d
    row, col, val = rc

    def mm_minmax(x):
        contrib = x[col] * val[:, None]
        out = torch.zeros((deg.shape[0], x.shape[1]), dtype=x.dtype,
                          device=x.device)
        out.scatter_reduce_(
            0, row[:, None].expand_as(contrib), contrib,
            "amax" if aggr == "max" else "amin", include_self=False)
        return torch.where(deg[:, None] > 0, out, torch.zeros_like(out))
    return mm_minmax


class _Init:
    """``nn.Linear`` layers on ``device`` with torch's default
    initialisation drawn from ``gen``, in the order they are made."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def linear(self, i: int, o: int, bias: bool = True) -> nn.Linear:
        lin = nn.Linear(i, o, bias=bias, device="meta").to_empty(
            device=self.device)
        with torch.no_grad():
            nn.init.kaiming_uniform_(lin.weight, a=math.sqrt(5),
                                     generator=self.gen)
            if bias:
                bound = 1.0 / math.sqrt(i) if i > 0 else 0.0
                nn.init.uniform_(lin.bias, -bound, bound, generator=self.gen)
        return lin

    def dropout(self, h: torch.Tensor, training: bool) -> torch.Tensor:
        """``nn.Dropout(0.5)``: the mask drawn from ``gen``."""
        if not training:
            return h
        noise = torch.empty_like(h).bernoulli_(0.5, generator=self.gen)
        return h * noise.div_(0.5)


class _GCN(nn.Module):
    """x' = Â(xW) + b per layer (bias after aggregation, PyG's GCNConv)."""

    def __init__(self, aggr, f: int, hidden: int, classes: int, init: _Init):
        super().__init__()
        self.aggr, self.init = aggr, init
        dev = init.device
        self.w1 = init.linear(f, hidden, bias=False)
        self.b1 = nn.Parameter(torch.zeros(hidden, device=dev))
        self.w2 = init.linear(hidden, classes, bias=False)
        self.b2 = nn.Parameter(torch.zeros(classes, device=dev))

    def forward(self, x):
        x = self.aggr(self.w1(x)) + self.b1
        x = self.init.dropout(torch.relu(x), self.training)
        x = self.aggr(self.w2(x)) + self.b2
        return torch.log_softmax(x, dim=-1)


class _SAGE(nn.Module):
    def __init__(self, aggr, f: int, hidden: int, classes: int, init: _Init):
        super().__init__()
        self.aggr, self.init = aggr, init
        self.l1 = init.linear(f, hidden)
        self.r1 = init.linear(f, hidden, bias=False)
        self.l2 = init.linear(hidden, classes)
        self.r2 = init.linear(hidden, classes, bias=False)

    def forward(self, x):
        x = self.l1(self.aggr(x)) + self.r1(x)
        x = self.init.dropout(torch.relu(x), self.training)
        x = self.l2(self.aggr(x)) + self.r2(x)
        return torch.log_softmax(x, dim=-1)


class _GIN(nn.Module):
    def __init__(self, aggr, f: int, hidden: int, classes: int, init: _Init):
        super().__init__()
        dev = init.device

        def mlp(i, o):
            return nn.Sequential(init.linear(i, o), nn.ReLU(),
                                 init.linear(o, o))

        self.aggr = aggr
        self.m1 = mlp(f, hidden)
        self.m2 = mlp(hidden, hidden)
        self.bn1 = nn.BatchNorm1d(hidden, device=dev)
        self.bn2 = nn.BatchNorm1d(hidden, device=dev)
        self.fc1 = init.linear(hidden, hidden)
        self.fc2 = init.linear(hidden, classes)

    def forward(self, x):
        x = self.bn1(self.m1(x + self.aggr(x)))
        x = self.bn2(self.m2(x + self.aggr(x)))
        x = torch.relu(self.fc1(x))
        return self.fc2(x)


_NETS = {"gcn": (_GCN, "nll"), "sage": (_SAGE, "nll"), "gin": (_GIN, "ce")}


def train_torch_baseline(model: str, ds, epochs: int = 2, hidden: int = 32,
                         aggr: str = "sum", seed: int = 0, lr: float = 0.01,
                         weight_decay: float = 5e-4,
                         device: str | torch.device = "cuda") -> TrainResult:
    """Train the plain-torch ``model`` (gcn | sage | gin; ``aggr`` is
    GraphSAGE's) full-batch on ``ds`` and evaluate it once; epochs are
    timed on the device's clock (CUDA events on a card).  Returns a
    :class:`TrainResult` (the same table)."""
    if model not in _NETS:
        raise ValueError(f"model must be one of {sorted(_NETS)}, got "
                         f"{model!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a, deg, rc = _graph_tensors(base_graph(ds.graph).to(dev))
    mm = _make_aggr(a, deg, rc, aggr if model == "sage" else "sum")

    x = torch.from_numpy(np.asarray(ds.x, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(ds.y, np.int64)).to(dev)
    train_mask = torch.from_numpy(np.asarray(ds.train_mask, bool)).to(dev)
    test_mask = torch.from_numpy(np.asarray(ds.test_mask, bool)).to(dev)

    cls, loss_kind = _NETS[model]
    net = cls(mm, x.shape[1], hidden, ds.num_classes, _Init(gen, dev))
    lossf = nn.NLLLoss() if loss_kind == "nll" else nn.CrossEntropyLoss()

    def adam():
        return torch.optim.Adam(net.parameters(), lr=lr,
                                weight_decay=weight_decay)

    def epoch(opt):
        opt.zero_grad()
        out = net(x)
        loss = lossf(out[train_mask], y[train_mask])
        loss.backward()
        opt.step()
        return loss.detach()

    net.train()
    init, gen_state = ({k: v.clone() for k, v in net.state_dict().items()},
                       gen.get_state())
    epoch(adam())
    net.load_state_dict(init)
    gen.set_state(gen_state)

    opt = adam()
    clock = _Clock(dev)
    losses = []
    for _ in range(epochs):
        clock.mark()
        losses.append(epoch(opt))
        clock.mark()
    epoch_times = clock.seconds()

    net.eval()
    with torch.no_grad():
        pred = net(x).argmax(dim=-1)
        train_acc = float((pred[train_mask] == y[train_mask]).float().mean())
        clock = _Clock(dev)
        clock.mark()
        out = net(x)
        clock.mark()
        test_time = clock.seconds()[0]
        pred = out.argmax(dim=-1)
        test_acc = float((pred[test_mask] == y[test_mask]).float().mean())

    return TrainResult(
        train_time_avg=float(np.mean(epoch_times)) if epochs else 0.0,
        train_time_std=float(np.std(epoch_times)) if epochs else 0.0,
        test_time=test_time,
        train_acc=train_acc,
        test_acc=test_acc,
        epoch_times=epoch_times,
        losses=torch.stack(losses).tolist() if losses else [],
        params=net.state_dict(),
    )
