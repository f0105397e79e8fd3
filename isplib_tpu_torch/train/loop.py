"""Full-batch node-classification training, the counterpart of
``isplib_tpu.train.loop``.

The reference protocol: Adam(lr=0.01, weight_decay=5e-4) with coupled L2
(``torch.optim.Adam``'s ``weight_decay``, which the JAX package matches with
``optax.add_decayed_weights`` before ``adam``), one warm-up epoch outside the
timed region, per-epoch times and the TRG_TM / TRG_STD / TST_TM / TRG_ACC /
TST_ACC table.  On CUDA the times come from CUDA events.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.synthetic import NodeDataset
from ..device import resolve_device
from ..dist.partition import ShardedGraph
from ..nn.conv import BatchNorm
from ..sparse.tiling import TiledGraph, auto_tile, base_graph
from ..utils.profiling import span

__all__ = ["TrainResult", "train_node_classifier", "make_train_step"]


@dataclasses.dataclass
class TrainResult:
    train_time_avg: float
    train_time_std: float
    test_time: float
    train_acc: float
    test_acc: float
    epoch_times: list[float]
    losses: list[float]          # training loss of each timed epoch
    params: dict

    def table(self) -> str:
        """The reference's result table (gcn-sparse.py:118-126)."""
        hdr = "\t".join(["TRG_TM", "TRG_STD", "TST_TM", "TRG_ACC", "TST_ACC"])
        row = (f"{self.train_time_avg:.4}\t{self.train_time_std:.4}\t"
               f"{self.test_time:.4}\t{self.train_acc:.4}\t{self.test_acc:.4}")
        return f"{hdr}\n{'-' * 40}\n{row}"


def _loss_fn(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             loss: str = "nll") -> torch.Tensor:
    """Masked mean loss.  ``'nll'`` expects log-probs (GCN and GraphSAGE
    emit log_softmax); ``'ce'`` expects raw logits (GIN) and is the softmax
    cross-entropy with integer labels."""
    if loss == "nll":
        per = -logits.gather(1, y[:, None].long())[:, 0]
    elif loss == "ce":
        per = F.cross_entropy(logits, y.long(), reduction="none")
    else:
        raise ValueError(f"loss must be 'nll' or 'ce', got {loss!r}")
    m = mask.to(per.dtype)
    return (per * m).sum() / m.sum().clamp(min=1.0)


def _masked_acc(logits, y, mask) -> torch.Tensor:
    m = mask.to(torch.float32)
    hit = (logits.argmax(dim=-1) == y).to(torch.float32)
    return (hit * m).sum() / m.sum().clamp(min=1.0)


class _Clock:
    """Intervals on the device's own clock: CUDA events on a card, the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        """Seconds between consecutive (start, end) mark pairs."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks[::2], self.marks[1::2])]
        return [b - a for a, b in zip(self.marks[::2], self.marks[1::2])]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    graph, loss: str = "nll", backend: Optional[str] = None):
    """One full-batch epoch as a function, the counterpart of the JAX
    package's ``make_train_step``.

    ``step(x, y, mask, generator)`` puts ``model`` in training mode, zeroes
    the gradients, runs the forward pass on ``graph`` (dropout masks drawn
    from ``generator``, a ``torch.Generator`` on x's device, or the global
    generator when None), the masked ``loss`` (``"nll"`` or ``"ce"``), the
    backward pass and ``optimizer.step()``, and returns ``(loss,
    train_accuracy)`` as 0-d tensors on x's device, without waiting for the
    device.  ``model`` is one of the port's models, whose forward takes
    ``generator`` and ``backend``; ``backend`` goes to every SpMM of the
    forward pass (``ops.spmm.spmm``; None: the process default).
    """

    def step(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        with span("isplib.step"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            logits = model(graph, x, generator=generator, backend=backend)
            lval = _loss_fn(logits, y, mask, loss)
            lval.backward()
            optimizer.step()
            return lval.detach(), _masked_acc(logits.detach(), y, mask)

    return step


def train_node_classifier(
    model: torch.nn.Module,
    ds: NodeDataset,
    epochs: int = 2,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    seed: int = 0,
    loss: Optional[str] = None,
    device: str | torch.device = "cuda",
    tile: bool = True,
) -> TrainResult:
    """Train ``model`` full-batch on ``ds`` and evaluate it once.

    With ``tile`` (the default) a large CSRGraph on CUDA is tiled first
    (``auto_tile`` at the feature width, which takes a configuration that
    ``tune_spmm`` recorded), so its SpMMs run the kernels, and a TiledGraph is used
    as it is; without it the SpMMs run the reference path on the plain
    graph, tiled or not.  A ShardedGraph (``dist.partition_rows``) is
    trained on as it is (without ``tile``, on its reference route), its
    SpMMs on the process-default mesh (``dist.set_mesh``), with global
    features and labels.  Without ``tile`` every SpMM of the run takes
    ``backend="reference"``, so a large plain graph is not tiled by
    ``spmm`` either.  ``loss`` defaults to ``'ce'`` for a model
    with batch statistics (GIN emits logits) and ``'nll'`` otherwise, as in
    the JAX package.  ``seed`` seeds the dropout generator.  The warm-up
    epoch's changes to the parameters and to the batch statistics are
    undone before the timed epochs.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    if loss is None:
        has_batch_stats = any(isinstance(m, BatchNorm)
                              for m in model.modules())
        loss = "ce" if has_batch_stats else "nll"
    graph = ds.graph
    if isinstance(graph, ShardedGraph):
        graph = (graph if tile else graph.without_plans()).to(dev)
    elif not tile:
        graph = base_graph(graph).to(dev)
    elif not isinstance(graph, TiledGraph):
        # the feature width keys the tune cache, as in the JAX package
        graph = auto_tile(graph if graph.device == dev else graph.to(dev),
                          k=int(np.asarray(ds.x).shape[-1]))
    if graph.device != dev:
        raise ValueError(f"the graph is on {graph.device}, not {dev}")
    x = torch.from_numpy(np.asarray(ds.x, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(ds.y)).to(dev)
    train_mask = torch.from_numpy(np.asarray(ds.train_mask)).to(dev)
    test_mask = torch.from_numpy(np.asarray(ds.test_mask)).to(dev)

    def adam():
        return torch.optim.Adam(model.parameters(), lr=lr,
                                weight_decay=weight_decay)

    # warm-up epoch (builds the kernels, first-call costs), then restore the
    # state_dict: the parameters and the BatchNorm running statistics
    init = {k: v.clone() for k, v in model.state_dict().items()}
    backend = None if tile else "reference"
    make_train_step(model, adam(), graph, loss, backend)(
        x, y, train_mask, torch.Generator(device=dev).manual_seed(seed))
    model.load_state_dict(init)

    step = make_train_step(model, adam(), graph, loss, backend)
    gen = torch.Generator(device=dev).manual_seed(seed)
    clock = _Clock(dev)
    losses, acc = [], None
    for _ in range(epochs):
        clock.mark()
        lval, acc = step(x, y, train_mask, gen)
        clock.mark()
        losses.append(lval)
    epoch_times = clock.seconds()
    losses = torch.stack(losses).tolist() if losses else []
    train_acc = float(acc) if acc is not None else 0.0

    model.eval()
    with torch.no_grad():
        model(graph, x, backend=backend)  # warm
        clock = _Clock(dev)
        clock.mark()
        logits = model(graph, x, backend=backend)
        clock.mark()
        test_time = clock.seconds()[0]
        test_acc = float(_masked_acc(logits, y, test_mask))

    return TrainResult(
        train_time_avg=float(np.mean(epoch_times)) if epochs else 0.0,
        train_time_std=float(np.std(epoch_times)) if epochs else 0.0,
        test_time=test_time,
        train_acc=train_acc,
        test_acc=test_acc,
        epoch_times=epoch_times,
        losses=losses,
        params=model.state_dict(),
    )
