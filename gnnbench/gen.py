"""Every input of a run, made on the device from ``--seed``: the edge list,
the features, labels and split, and the model's parameters.

The graph follows the law of the port's ``data/synthetic.py`` (``rmat_edges``,
``rmat_dataset``), rewritten here in torch for the device: R-MAT with a, b, c
from the graph's file, self loops removed, duplicates kept, every edge
mirrored where the file says so; features are class centroids plus
Gaussian noise.  The same seed gives the same inputs on the same kind of
device; the structure is the graph file's, whatever the seed.  Nothing is written to disk.  This module imports nothing of the
port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Inputs", "make_inputs", "rmat", "draw_parameters"]


@dataclasses.dataclass
class Inputs:
    edge_index: torch.Tensor   # (2, E) int64 [src; dst]
    x: torch.Tensor            # (N, F) float32
    y: torch.Tensor            # (N,) int64
    train: torch.Tensor        # (N,) bool
    val: torch.Tensor
    test: torch.Tensor
    params: dict               # name -> float32 tensor


def rmat(num_nodes: int, num_draws: int, a: float, b: float, c: float,
         gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_draws`` R-MAT edges (src, dst), int64, before any filtering:
    one uniform draw per level picks the quadrant (a top-left, b top-right,
    c bottom-left), ids folded into range modulo ``num_nodes``."""
    levels = max(1, math.ceil(math.log2(max(num_nodes, 2))))
    src = torch.zeros(num_draws, dtype=torch.int64, device=device)
    dst = torch.zeros(num_draws, dtype=torch.int64, device=device)
    for _ in range(levels):
        r = torch.rand(num_draws, generator=gen, device=device)
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        down = r >= a + b
        src = src * 2 + down
        dst = dst * 2 + right
    return src % num_nodes, dst % num_nodes


def _edges(spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    law = spec["law"]
    if law["kind"] != "rmat" or law["self_loops"] or not law["duplicates"]:
        raise ValueError(f"no generator for the law {law}")
    n, e = spec["nodes"], spec["edges"]
    if law["mirrored"] and e % 2:
        raise ValueError("a mirrored graph has an even number of edges")
    draws = e // 2 if law["mirrored"] else e
    # self loops are ~2e-4 of the draws on this law: draw a margin, keep the
    # first ``draws`` that are not loops
    src, dst = rmat(n, draws + draws // 256 + 64, law["a"], law["b"],
                    law["c"], gen, device)
    keep = src != dst
    src, dst = src[keep][:draws], dst[keep][:draws]
    if src.numel() < draws:
        raise RuntimeError(f"R-MAT gave {src.numel()} edges without self "
                           f"loops, fewer than {draws}")
    if law["mirrored"]:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    return torch.stack([src, dst])


def draw_parameters(layout, gen: torch.Generator, device) -> dict:
    """Parameters from one uniform draw: ``layout`` is ``[(name, shape,
    law)]`` with law ``glorot_uniform`` (U(±sqrt(6 / (fan_in + fan_out)))),
    ``lecun_normal`` (a normal of variance 1 / fan_in truncated at ±2
    standard deviations, by its inverse CDF) or ``zeros``."""
    sizes = [math.prod(shape) for _, shape, _ in layout]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
    for (name, shape, law), size in zip(layout, sizes):
        v = u[at:at + size].view(shape)
        at += size
        if law == "zeros":
            p = torch.zeros(shape, device=device)
        elif law == "glorot_uniform":
            fan_in, fan_out = shape
            p = (v * 2.0 - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        elif law == "lecun_normal":
            std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
            q = lo + v * (1.0 - 2.0 * lo)
            p = std * math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)
        else:
            raise ValueError(f"unknown parameter law {law!r}")
        out[name] = p.contiguous()
    return out


def make_inputs(spec: dict, layout, seed: int, device) -> Inputs:
    """The inputs of one run of a cell on ``spec`` (a graph file's dict),
    with parameters of ``layout`` (the reference's ``parameters``).

    The structure comes from the graph's own ``structure_seed``, as a
    deployment trains on one graph: every seed gives the kernels the same
    work.  ``seed`` draws the features, labels, split and parameters."""
    n, f, c = spec["nodes"], spec["features"], spec["classes"]
    structure = torch.Generator(device=device).manual_seed(
        spec["law"]["structure_seed"])
    edge_index = _edges(spec, structure, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(0, c, (n,), generator=gen, device=device)
    centers = torch.randn(c, f, generator=gen, device=device)
    x = centers[y] + spec["feature_noise"] * torch.randn(
        n, f, generator=gen, device=device)
    split = spec["split"]
    if split["train"] + split["val"] + split["test"] != n:
        raise ValueError(f"the split {split} does not cover {n} nodes")
    perm = torch.randperm(n, generator=gen, device=device)
    masks = []
    at = 0
    for part in ("train", "val", "test"):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[perm[at:at + split[part]]] = True
        at += split[part]
        masks.append(m)
    params = draw_parameters(layout, gen, device)
    return Inputs(edge_index, x, y, *masks, params)
