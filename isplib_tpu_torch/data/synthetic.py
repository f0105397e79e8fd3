"""Synthetic graphs, the counterpart of ``isplib_tpu.data.synthetic`` plus
the two graph generators of the JAX package's ``bench.py``.

Everything is made on the host from a seed, so a call builds the graph
that the JAX package's numpy paths build from it (R-MAT's native stream only
where a caller asks for it); only the final graph lives on a torch device.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..sparse.graph import CSRGraph, _build_arrays, from_edge_index
from ..sparse.tiling import TiledGraph

__all__ = ["NodeDataset", "rmat_edges", "rmat_dataset", "sbm_dataset",
           "gen_rmat_graph", "gen_gcnsig_graph"]

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class NodeDataset:
    """A full-batch node-classification dataset (host-side features)."""

    name: str
    graph: CSRGraph | TiledGraph  # a TiledGraph trains on its plans
    x: np.ndarray            # (N, F) float32
    y: np.ndarray            # (N,) int32
    train_mask: np.ndarray   # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])


def rmat_edges(num_nodes: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               native_stream: bool = False) -> np.ndarray:
    """Vectorised R-MAT edges (power-law degrees), (2, E) int64 [src; dst],
    self loops removed, duplicates kept.

    The default stream is the JAX package's numpy path (``default_rng``),
    so a seed names one graph whatever is built.  ``native_stream`` takes
    the native generator's SplitMix64 stream (``native.rmat``, the JAX
    package's when its library loads), another graph of the same law,
    drawn in parallel."""
    if native_stream:
        from .. import native
        src, dst = native.rmat(num_edges, num_nodes, seed, a, b, c)
        keep = src != dst
        return np.stack([src[keep].astype(np.int64),
                         dst[keep].astype(np.int64)])
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        r = rng.random(num_edges)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src = src * 2 + go_down
        dst = dst * 2 + go_right
    src %= num_nodes
    dst %= num_nodes
    keep = src != dst
    return np.stack([src[keep], dst[keep]])


def rmat_dataset(
    num_nodes: int,
    num_edges: int,
    num_features: int,
    num_classes: int,
    name: str = "rmat",
    seed: int = 0,
    edge_multiple: int = 4096,
    undirected: bool = True,
    device: str | torch.device = "cuda",
    tiling: dict | None = None,
) -> NodeDataset:
    """Size-matched benchmark dataset: R-MAT structure with class-correlated
    features (class centroids plus noise of scale 2); ``tiling`` as in
    ``from_edge_index``."""
    rng = np.random.default_rng(seed + 1)
    ei = rmat_edges(num_nodes, num_edges, seed)
    if undirected:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
    graph = from_edge_index(ei, num_nodes=num_nodes,
                            edge_multiple=edge_multiple, device=device,
                            tiling=tiling)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    centers = rng.normal(size=(num_classes, num_features)).astype(np.float32)
    x = centers[y] + rng.normal(
        scale=2.0, size=(num_nodes, num_features)).astype(np.float32)
    masks = _split_masks(num_nodes, rng)
    return NodeDataset(name, graph, x.astype(np.float32), y, *masks,
                       num_classes=num_classes)


def sbm_dataset(
    num_nodes: int = 2000,
    num_classes: int = 7,
    num_features: int = 64,
    avg_degree: float = 10.0,
    homophily: float = 0.8,
    noise: float = 1.0,
    seed: int = 0,
    edge_multiple: int = 512,
    name: str = "sbm",
    device: str | torch.device = "cuda",
) -> NodeDataset:
    """Stochastic-block-model dataset whose neighbourhoods carry the class
    signal that the noisy features alone do not."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    num_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, size=3 * num_edges)
    dst = rng.integers(0, num_nodes, size=3 * num_edges)
    same = y[src] == y[dst]
    use = rng.random(3 * num_edges) < np.where(same, homophily,
                                               1.0 - homophily)
    src, dst = src[use][:num_edges], dst[use][:num_edges]
    keep = src != dst
    ei = np.stack([src[keep], dst[keep]])
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    graph = from_edge_index(ei, num_nodes=num_nodes,
                            edge_multiple=edge_multiple, device=device)
    centers = rng.normal(size=(num_classes, num_features)).astype(np.float32)
    x = (centers[y] + noise * rng.normal(
        size=(num_nodes, num_features))).astype(np.float32)
    masks = _split_masks(num_nodes, rng)
    return NodeDataset(name, graph, x, y, *masks, num_classes=num_classes)


def _split_masks(num_nodes: int, rng) -> tuple[np.ndarray, ...]:
    """60/20/20 random train/val/test split."""
    perm = rng.permutation(num_nodes)
    train = np.zeros(num_nodes, bool)
    val = np.zeros(num_nodes, bool)
    test = np.zeros(num_nodes, bool)
    n_train = int(0.6 * num_nodes)
    n_val = int(0.2 * num_nodes)
    train[perm[:n_train]] = True
    val[perm[n_train:n_train + n_val]] = True
    test[perm[n_train + n_val:]] = True
    return train, val, test


def gen_rmat_graph(num_nodes: int, num_edges: int, seed: int,
                   edge_multiple: int = 4096) -> dict:
    """Host arrays of an R-MAT graph (``bench.py``'s ``gen_rmat_graph``)."""
    ei = rmat_edges(num_nodes, num_edges, seed)
    return _build_arrays(ei[1], ei[0], None, num_nodes, num_nodes,
                         edge_multiple)


def gen_gcnsig_graph(num_nodes: int, num_edges: int, num_classes: int,
                     feat_dim: int, seed: int, edge_multiple: int = 4096,
                     native_stream: bool = False) -> dict:
    """Host arrays of ``bench.py``'s GCN-signal graph: 80% R-MAT structure
    plus 20% intra-class edges, GCN-normalised with self loops, and features
    that are class centroids plus noise, so a working GCN reaches high
    train accuracy.  Adds ``x``, ``y``, ``train_mask`` and ``test_mask``.
    ``native_stream`` as in :func:`rmat_edges`.  The host seconds of the
    R-MAT draw and of ``_build_arrays`` are logged at INFO."""
    rng = np.random.default_rng(seed + 17)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)

    e_rmat = int(num_edges * 0.8)
    e_homo = num_edges - e_rmat
    t0 = time.perf_counter()
    ei = rmat_edges(num_nodes, e_rmat, seed, native_stream=native_stream)
    t_rmat = time.perf_counter() - t0
    src = rng.integers(0, num_nodes, size=e_homo).astype(np.int64)
    cls_nodes = [np.flatnonzero(y == c2) for c2 in range(num_classes)]
    dst = np.empty(e_homo, np.int64)
    for c2 in range(num_classes):
        m = y[src] == c2
        dst[m] = rng.choice(cls_nodes[c2], size=int(m.sum()))
    keep = src != dst
    ei = np.concatenate([ei, np.stack([src[keep], dst[keep]])], axis=1)

    s = np.concatenate([ei[0], np.arange(num_nodes)])
    d = np.concatenate([ei[1], np.arange(num_nodes)])
    deg = np.bincount(d, minlength=num_nodes).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    vals = (dinv[d] * dinv[s]).astype(np.float32)

    t0 = time.perf_counter()
    arrays = _build_arrays(d, s, vals, num_nodes, num_nodes, edge_multiple)
    _log.info("GCN-signal graph of %d nodes, %d edges: R-MAT (%s) %.3fs, "
              "_build_arrays %.3fs", num_nodes, arrays["nnz"],
              "SplitMix64" if native_stream else "numpy", t_rmat,
              time.perf_counter() - t0)
    centers = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = (centers[y] + 2.5 * rng.normal(size=(num_nodes, feat_dim))
         ).astype(np.float32)
    perm = rng.permutation(num_nodes)
    train = np.zeros(num_nodes, bool)
    train[perm[: int(0.6 * num_nodes)]] = True
    test = np.zeros(num_nodes, bool)
    test[perm[int(0.8 * num_nodes):]] = True
    arrays.update(x=x, y=y, train_mask=train, test_mask=test)
    return arrays
