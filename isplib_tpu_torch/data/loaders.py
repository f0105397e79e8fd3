"""Dataset loaders, the counterpart of ``isplib_tpu.data.loaders``.

``load(name)`` reads an exported dataset ``$ISPLIB_DATA/<name>.npz`` (keys
``edge_index (2, E) | x (N, F) | y (N,) | train_mask | val_mask |
test_mask``; default directory ``~/datasets/isplib``), one of the small
real graphs checked in under ``data/real/`` (karate, lesmis), or, when the
file is missing or the name ends in ``-sim``, a size-matched synthetic R-MAT
stand-in (``rmat_dataset``).

The stand-in's seed is ``zlib.crc32(name) % 2**31``.  The JAX package uses
``hash(name) % 2**31``, which Python randomises per process, so its
stand-ins differ from run to run; the port's do not.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
import torch

from ..sparse.graph import from_edge_index, from_scipy
from .synthetic import NodeDataset, rmat_dataset

__all__ = ["load", "load_mtx", "pad_features", "DATASET_STATS",
           "REAL_BUILTIN", "standin_seed"]

DATA_DIR = os.environ.get(
    "ISPLIB_DATA", os.path.join(os.path.expanduser("~"), "datasets", "isplib"))

# (num_nodes, num_edges_directed, num_features, num_classes) of the
# reference's six datasets; they size the synthetic stand-ins.
DATASET_STATS = {
    "reddit": (232_965, 114_615_892, 602, 41),
    "reddit2": (232_965, 23_213_838, 602, 41),
    "amazon": (1_569_960, 264_339_468, 200, 107),
    "protein": (132_534, 79_122_504, 8, 112),
    "product": (2_449_029, 123_718_280, 100, 47),
    "mag": (736_389, 10_832_542, 128, 349),
}

# Small real graphs checked into the repo (data/real/*.mtx with labels).
REAL_BUILTIN = ("karate", "lesmis")
_REAL_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "real")


def _npz_path(name: str) -> str:
    return os.path.join(DATA_DIR, f"{name}.npz")


def _load_npz(name: str, device) -> NodeDataset:
    with np.load(_npz_path(name)) as z:
        edge_index = z["edge_index"]
        x = z["x"].astype(np.float32)
        y = z["y"].astype(np.int32)
        masks = [z[m].astype(bool)
                 for m in ("train_mask", "val_mask", "test_mask")]
    graph = from_edge_index(edge_index, num_nodes=x.shape[0],
                            edge_multiple=4096, device=device)
    return NodeDataset(name, graph, x, y, *masks,
                       num_classes=int(y.max()) + 1)


def pad_features(ds: NodeDataset) -> NodeDataset:
    """Zero-pad the feature dimension up to a multiple of 128 (the JAX
    package's lane width; the CLI does it unless ``--nopad``)."""
    f = ds.x.shape[1]
    target = -(-f // 128) * 128
    if target == f:
        return ds
    x = np.concatenate(
        [ds.x, np.zeros((ds.x.shape[0], target - f), ds.x.dtype)], axis=1)
    return dataclasses.replace(ds, x=x)


def standin_seed(name: str) -> int:
    """The seed of ``name``'s synthetic stand-in, the same in every
    process."""
    return zlib.crc32(name.encode()) % (2**31)


def _synthetic_standin(name: str, scale: float, device) -> NodeDataset:
    n, e, f, c = DATASET_STATS[name]
    return rmat_dataset(num_nodes=int(n * scale), num_edges=int(e * scale),
                        num_features=f, num_classes=c, name=f"{name}-sim",
                        seed=standin_seed(name), undirected=False,
                        device=device)


def load_mtx(path: str, labels_npz: str | None = None,
             name: str | None = None,
             device: str | torch.device = "cuda") -> NodeDataset:
    """A MatrixMarket adjacency plus optional labels as a NodeDataset.

    Features are one-hot node ids up to 4096 nodes (they take O(n²)
    memory), else 128 normal features from seed 0; a random half of the
    nodes (seed 0) trains and the other half tests.
    """
    import scipy.io

    mat = scipy.io.mmread(path).tocoo()
    graph = from_scipy(mat, edge_multiple=128, device=device)
    n = graph.num_rows
    if labels_npz is not None:
        with np.load(labels_npz) as z:
            y = z["y"].astype(np.int32)
    else:
        y = np.zeros(n, np.int32)
    if n <= 4096:
        x = np.eye(n, dtype=np.float32)
    else:
        x = np.random.default_rng(0).normal(size=(n, 128)).astype(np.float32)
    perm = np.random.default_rng(0).permutation(n)
    train = np.zeros(n, bool)
    train[perm[: n // 2]] = True
    return NodeDataset(name or os.path.basename(path), graph, x, y,
                       train_mask=train, val_mask=~train, test_mask=~train,
                       num_classes=int(y.max()) + 1)


def load(name: str, allow_synthetic: bool = True, scale: float = 1.0,
         device: str | torch.device = "cuda") -> NodeDataset:
    """One of the six reference datasets (``<name>-sim`` forces the
    stand-in; ``scale`` shrinks stand-ins), or a checked-in real graph."""
    if name in REAL_BUILTIN:
        return load_mtx(os.path.join(_REAL_DIR, f"{name}.mtx"),
                        labels_npz=os.path.join(_REAL_DIR,
                                                f"{name}_labels.npz"),
                        name=name, device=device)
    force_sim = name.endswith("-sim")
    base = name[:-4] if force_sim else name
    if base not in DATASET_STATS:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(DATASET_STATS) + list(REAL_BUILTIN)}")
    if not force_sim and os.path.exists(_npz_path(base)):
        return _load_npz(base, device)
    if not (allow_synthetic or force_sim):
        raise FileNotFoundError(
            f"{_npz_path(base)} not found; pass allow_synthetic=True for a "
            "size-matched R-MAT stand-in")
    if not force_sim:
        print(f"[isplib_tpu_torch.data] {base}: no exported .npz at "
              f"{_npz_path(base)}; using the size-matched synthetic stand-in")
    return _synthetic_standin(base, scale, device)
