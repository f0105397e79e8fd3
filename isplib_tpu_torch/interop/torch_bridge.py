"""The torch/PyG patch surface, the counterpart of
``isplib_tpu.interop.torch_bridge``: an unmodified PyG or torch model runs
its sparse products on the port's SpMM.

* ``torch_spmm(src, other, reduce)`` and its alias ``spmm_autotuned`` take
  a ``torch_sparse.SparseTensor`` (duck-typed by ``.csr()`` and
  ``.sparse_sizes()``), a torch sparse CSR tensor or a torch sparse COO
  tensor (coalesced first, so duplicates sum), with value 1 where the
  container has no values, and a dense (C, K) ``other``; ``reduce`` is
  sum (alias ``add``), mean, max or min.
* ``iSpLibPlugin.patch_pyg`` replaces ``torch.sparse.mm`` and, where they
  import, ``torch_sparse.matmul`` and PyG's ``WITH_PT2``/``WITH_PT20`` flags
  (forced to False, so PyG aggregates through ``torch_sparse``);
  ``unpatch_pyg`` restores them; ``isplib_autotune`` patches for one call.

Unlike the JAX bridge, nothing crosses to the host per call: the product
runs the port's differentiable ``spmm`` on the caller's own tensors, and
the result and the gradient stay on ``other``'s device.  The index arrays
go to the host once per distinct adjacency, where the numpy builder makes
the graph (as ``from_scipy`` does), which then lives on ``other``'s device
and is cached under the data pointers of the keyed index and value tensors
and the shape; the entry holds those tensors, so their memory cannot be
reused by other tensors while it lives.  The cache keeps the
``CACHE_SIZE`` adjacencies used last: a model that makes a new value
tensor on every call (PyG's ``GCNConv`` with ``cached=False`` renormalises
each forward) builds a new graph, and under ``"auto"`` new plans, on every
call, with memory bounded by the cache; cache the normalised adjacency
(``cached=True``) to build once.  Under the ``"auto"`` backend a large
CUDA graph is tiled by ``spmm`` (``auto_tile``), so sum and mean run the
hybrid kernels and max and min the max/min kernel.  A sparse operand
and a dense operand on different devices raise; neither is moved.

Gradients flow to the dense operand only, as in the JAX bridge and the
reference: the graph holds a copy of the edge values, so values that
require a gradient get none through the bridge (differentiate them through
``spmm`` on a graph with ``CSRGraph.with_value``).  The bridge never calls
``torch.sparse.mm``, which it may have replaced.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import numpy as np
import torch

from ..ops.spmm import _check_backend, spmm
from ..sparse.graph import from_scipy

__all__ = ["iSpLibPlugin", "isplib_autotune", "spmm_autotuned",
           "torch_spmm", "clear_cache"]

# (device, index and value data pointers, shape) -> (graph, the keyed
# tensors), the reference's per-data_ptr caches (isplib/__init__.py:51-80),
# least recently used first and bounded by CACHE_SIZE
CACHE_SIZE = 4
_graph_cache: collections.OrderedDict = collections.OrderedDict()

# set by patch_pyg: the backend of the bridged calls (None: the process
# default) and the tiling dict of the graph build
_config: dict = {"backend": None, "tiling": None}


def clear_cache() -> None:
    """Drop every cached graph and the tensors its entry holds."""
    _graph_cache.clear()


def _parts(src):
    """``(keyed tensors, shape, device, to_csr)`` of a sparse operand;
    ``to_csr()`` gives its ``(rowptr, col, value or None)``, called only to
    build the graph."""
    if hasattr(src, "csr") and hasattr(src, "sparse_sizes"):
        rowptr, col, value = src.csr()
        keyed = (rowptr, col, value)
        return keyed, tuple(src.sparse_sizes()), col.device, lambda: keyed
    if isinstance(src, torch.Tensor) and src.layout == torch.sparse_csr:
        keyed = (src.crow_indices(), src.col_indices(), src.values())
        return keyed, tuple(src.shape), src.device, lambda: keyed
    if isinstance(src, torch.Tensor) and src.layout == torch.sparse_coo:
        def to_csr():
            c = src.coalesce().to_sparse_csr()
            return c.crow_indices(), c.col_indices(), c.values()
        return ((src._indices(), src._values()), tuple(src.shape), src.device,
                to_csr)
    raise TypeError(f"unsupported sparse operand: {type(src)!r}")


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def _get_graph(src, device: torch.device):
    keyed, shape, src_device, to_csr = _parts(src)
    if src_device != device:
        raise ValueError(f"the sparse operand is on {src_device} and the "
                         f"dense one on {device}; move one of them")
    key = (str(device),
           tuple(t.data_ptr() if t is not None else 0 for t in keyed), shape)
    hit = _graph_cache.get(key)
    if hit is not None:
        _graph_cache.move_to_end(key)
        return hit[0]
    import scipy.sparse as sp

    rowptr, col, value = to_csr()
    col_np = _host(col, np.int64)
    val_np = (np.ones(col_np.shape[0], np.float32) if value is None
              else _host(value, np.float32))
    mat = sp.csr_matrix((val_np, col_np, _host(rowptr, np.int64)),
                        shape=shape)
    graph = from_scipy(mat, device=device, tiling=_config["tiling"])
    _graph_cache[key] = (graph, keyed)
    while len(_graph_cache) > CACHE_SIZE:
        _graph_cache.popitem(last=False)
    return graph


_REDUCE_ALIASES = {"add": "sum", "sum": "sum", "mean": "mean",
                   "max": "max", "min": "min"}


def torch_spmm(src, other: torch.Tensor, reduce: str = "sum"):
    """``reduce(src ⊙ other)`` through the port's ``spmm``, differentiable
    in ``other``; ``other`` is cast to float32, the result is (R, K)
    float32 on ``other``'s device."""
    reduce = _REDUCE_ALIASES[reduce]
    graph = _get_graph(src, other.device)
    return spmm(graph, other.float(), reduce, backend=_config["backend"])


def spmm_autotuned(src, other: torch.Tensor, reduce: str = "sum"):
    """The patched ``torch_sparse.matmul`` (reference
    ``isplib/__init__.py:48,140-155``)."""
    return torch_spmm(src, other, reduce)


def _patched_sparse_mm(sparse, dense, *args, **kwargs):
    return torch_spmm(sparse, dense, reduce="sum")


class iSpLibPlugin:
    """The monkey-patching plugin (reference
    ``isplib/__init__.py:41-202``); ``backup`` holds ``(object, name,
    original)`` of every patched attribute."""

    backup: list = []

    @classmethod
    def patch_pyg(cls, backend: Optional[str] = None,
                  tiling: Optional[dict] = None) -> None:
        """Reroute torch's and torch_sparse's sparse matmuls through the
        port.  ``backend``: ``"auto"`` or ``"reference"`` for the bridged
        calls, None for the process default (``set_default_backend``; the
        JAX bridge's default is its plain ``xla`` path).  ``tiling``: a dict
        of ``build_tiling`` keys for the graph build, as ``from_edge_index``
        takes it.  Patching again while patched does nothing."""
        if cls.backup:
            return
        if backend is not None:
            _check_backend(backend)
        if tiling is not None and not isinstance(tiling, dict):
            raise TypeError(f"tiling must be None or a dict of build_tiling "
                            f"keys, got {type(tiling).__name__}")
        _config.update(backend=backend, tiling=tiling)

        cls.backup.append((torch.sparse, "mm", torch.sparse.mm))
        torch.sparse.mm = _patched_sparse_mm
        try:
            import torch_sparse
            cls.backup.append((torch_sparse, "matmul", torch_sparse.matmul))
            torch_sparse.matmul = spmm_autotuned
        except ImportError:
            pass
        try:
            import torch_geometric.typing as pyg_typing
            for flag in ("WITH_PT2", "WITH_PT20"):
                if hasattr(pyg_typing, flag):
                    cls.backup.append(
                        (pyg_typing, flag, getattr(pyg_typing, flag)))
                    setattr(pyg_typing, flag, False)
        except ImportError:
            pass

    @classmethod
    def unpatch_pyg(cls) -> None:
        """Restore every patched attribute (reference
        ``isplib/__init__.py:187-202``)."""
        while cls.backup:
            obj, name, orig = cls.backup.pop()
            setattr(obj, name, orig)
        _config.update(backend=None, tiling=None)


def isplib_autotune(fn):
    """Decorator: ``patch_pyg()`` for the duration of each call, undone
    even when the call raises (reference ``isplib/__init__.py:204-210``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        iSpLibPlugin.patch_pyg()
        try:
            return fn(*args, **kwargs)
        finally:
            iSpLibPlugin.unpatch_pyg()

    return wrapper
