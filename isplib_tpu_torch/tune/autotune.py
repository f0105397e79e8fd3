"""The measured SpMM autotuner, the counterpart of ``isplib_tpu.tune.autotune``.

``tune_spmm`` times the reference path and every plan configuration through
``spmm`` on the graph's device (CUDA events on a card), records the fastest
in a JSON cache keyed by the graph's signature (rows, columns, edges, mean
degree, K, dtype, device type), and builds the winner's plans through the
plan cache (``sparse.plan_cache``), so that ``auto_tile`` and
``train_node_classifier`` later take the winner from both caches without
building anything.

The JAX package's ``lookup_backend`` answers for a graph inside a ``jit``
trace, which cannot be tiled mid-trace; PyTorch runs eagerly, so the port
has no trace and ``auto_tile``'s lookup is the whole decision.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["signature_of", "graph_signature", "record", "lookup",
           "tune_spmm", "DEFAULT_CONFIGS"]

_CACHE_PATH = os.environ.get(
    "ISPLIB_TPU_TORCH_TUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "isplib_tpu_torch",
                 "tune.json"))
_lock = threading.Lock()
_memory_cache: Optional[dict[str, Any]] = None


def signature_of(graph, k: int, dtype: str = "float32") -> str:
    """The JAX package's signature string; the device is the graph's device
    type (``cpu`` or ``cuda``)."""
    avg_deg = graph.nnz / max(graph.num_rows, 1)
    return (f"r{graph.num_rows}_c{graph.num_cols}_e{graph.nnz}"
            f"_d{avg_deg:.1f}_k{k}_{dtype}_{graph.device.type}")


def graph_signature(graph, x: torch.Tensor) -> str:
    return signature_of(graph, int(x.shape[-1]),
                        str(x.dtype).removeprefix("torch."))


def _load_cache() -> dict[str, Any]:
    global _memory_cache
    with _lock:
        if _memory_cache is None:
            try:
                with open(_CACHE_PATH) as f:
                    _memory_cache = json.load(f)
            except (OSError, json.JSONDecodeError):
                _memory_cache = {}
        return _memory_cache


def _save_cache(cache: dict[str, Any]) -> None:
    with _lock:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        tmp = _CACHE_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, _CACHE_PATH)  # atomic: readers see all or nothing


def record(key: str, entry: dict[str, Any]) -> None:
    cache = _load_cache()
    cache[key] = entry
    _save_cache(cache)


def lookup(key: str) -> Optional[dict[str, Any]]:
    return _load_cache().get(key)


# build_tiling keys, the JAX package's DEFAULT_CONFIGS reduced to the keys
# that shape the port's plans (its v5 stripes and DMA groups rb, S, g, gd
# do not exist on Hopper, so its six v5 entries collapse to three
# thresholds)
DEFAULT_CONFIGS = [
    dict(version=5, dense_threshold=64),
    dict(version=5, dense_threshold=128),
    dict(version=5, dense_threshold=192),
    dict(version=3, rb=256, ct=128, eb=512, dense_threshold=64, g=32),
    dict(version=3, rb=256, ct=128, eb=512, dense_threshold=96, g=16),
    dict(version=2, rb=256, ct=512, eb=512),
    dict(version=2, rb=512, ct=512, eb=512, gd=4),
    dict(version=2, rb=512, ct=1024, eb=512, gd=8),
    dict(version=1, rb=256, ct=512, eb=512),
]


def tune_spmm(graph, arrays: Optional[dict] = None, k: int = 32,
              configs=None, iters: int = 15, include_reference: bool = True,
              verbose: bool = True, built=None):
    """Time SpMM configurations on the graph's device and record the winner
    under the graph's signature; return ``(best_entry, tiled)``.

    ``graph`` is a square CSRGraph (each call's output feeds the next);
    ``arrays`` its host numpy arrays (``_build_arrays``' dict), read back
    from the device when None.  Each configuration is a dict of
    ``build_tiling`` keys, built forward-only and timed through
    ``spmm(tiled, x)`` with ``chain_time``.  A configuration whose plan
    build rejects its keys or geometry (``ValueError``, before any launch)
    is reported and skipped; an error from running it (a kernel that fails
    to build or launch) propagates, and nothing is recorded.  ``built``, if
    given, holds one TiledGraph per configuration, built at this ``k``,
    timed as it is instead of building it.

    A kernel winner's full TiledGraph (with the transpose plan) is built
    with ``cache_tag`` = the signature, so its plans persist (a ``built``
    winner that has its transpose plan is persisted as it is); ``tiled`` is
    None when the reference path wins.  Entries hold ``backend``
    (``"kernels"`` or ``"reference"``), the configuration's keys,
    ``seconds``, ``edges_per_s`` and ``fill``.
    """
    from ..ops.spmm import spmm
    from ..sparse.tiling import (PLAN_KEYS, build_tiling_from_numpy,
                                 host_arrays, save_tiling)
    from ..utils.timing import chain_time

    if arrays is None:
        arrays = host_arrays(graph)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(graph.num_cols, k)).astype(np.float32)).to(graph.device)
    key = graph_signature(graph, x)
    results = []  # (entry, index of its configuration or None)

    def say(msg):
        if verbose:
            print(f"[tune] {msg}", file=sys.stderr, flush=True)

    if include_reference:
        dt = chain_time(lambda x_: spmm(graph, x_, backend="reference")
                        * 1e-3, x, iters)
        results.append((dict(backend="reference", seconds=dt,
                             edges_per_s=graph.nnz / dt), None))
        say(f"reference: {dt * 1e3:.4f} ms "
            f"({graph.nnz / dt / 1e9:.3f} Gedges/s)")

    configs = list(configs or DEFAULT_CONFIGS)
    if built is not None and len(built) != len(configs):
        raise ValueError(f"built holds {len(built)} TiledGraphs for "
                         f"{len(configs)} configurations")
    for i, cfg in enumerate(configs):
        tag = " ".join(f"{f}={v}" for f, v in cfg.items())
        if built is not None:
            tg = built[i]
        else:
            try:
                tg = build_tiling_from_numpy(graph, arrays,
                                             build_backward=False, k=k, **cfg)
            except ValueError as ex:  # rejected before any launch
                say(f"kernels {tag} rejected: {str(ex)[:160]}")
                continue
        dt = chain_time(lambda x_, tg=tg: spmm(tg, x_) * 1e-3, x, iters)
        results.append((dict(backend="kernels", seconds=dt,
                             edges_per_s=graph.nnz / dt, fill=tg.fwd.fill,
                             **cfg), i))
        say(f"kernels {tag} fill={tg.fwd.fill:.3f}: {dt * 1e3:.4f} ms "
            f"({graph.nnz / dt / 1e9:.3f} Gedges/s)")
        del tg

    if not results:
        raise ValueError("tune_spmm: every configuration was rejected")
    best, i = min(results, key=lambda r: r[0]["seconds"])
    tiled = None
    if best["backend"] == "kernels":
        version = best["version"]
        cfg = {f: best[f] for f in PLAN_KEYS[version] if f in best}
        if built is not None and built[i].bwd is not None:
            tiled = built[i]
            save_tiling(tiled, arrays, version=version, k=k, cache_tag=key,
                        **cfg)
        else:
            tiled = build_tiling_from_numpy(graph, arrays, version=version,
                                            k=k, cache_tag=key, **cfg)
    record(key, best)
    say(f"best: {best}")
    return best, tiled
