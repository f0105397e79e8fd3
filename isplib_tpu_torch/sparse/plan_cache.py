"""Persistent cache of built plans, the counterpart of
``isplib_tpu.sparse.plan_cache``.

A plan build takes seconds of host work for a graph of millions of edges;
the cache persists the plans of a (graph, configuration) pair so that a
later run loads them instead.  The key folds in every plan-shaping argument,
a content fingerprint of the graph and ``PLAN_FORMAT_VERSION``, so a stale
entry is missed, never misread.

Format: ``np.savez`` with ``allow_pickle=False``, the format version stored
beside the plans (``fmt``; a file without it is format 2 or older).  A plan
tree (dicts, tuples, lists, None, scalars, tensors and the port's plan
dataclasses) is flattened into arrays plus a JSON spec that names each
dataclass by module path, accepted only from ``isplib_tpu_torch.`` modules, so
a cache directory can never run code.  Tensors are stored from the CPU and the
spec records each one's dtype: a bf16 tensor is stored as its int16 bits and
comes back as bf16, bit for bit (the JAX package's npz loses bf16 as ``|V2``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import sys
import tempfile
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["plan_cache_path", "save_host_plans", "load_host_plans",
           "default_cache_dir", "graph_fingerprint", "tree_to",
           "PLAN_FORMAT_VERSION"]

# Bump when a plan layout or a plan dataclass changes incompatibly.  2: the
# v1 and v3 plans carry their kernels' schedules (``sched``); 3: so do the
# v5 plans (K2's) and the v2 plans without edge ids (K8's).
PLAN_FORMAT_VERSION = 3

_MODULE_PREFIX = "isplib_tpu_torch."

# the dtypes of the plans' tensors, and the numpy dtype that stores the bits
_STORED_AS = {
    torch.bfloat16: np.int16,
    torch.float32: np.float32,
    torch.int32: np.int32,
}
_DTYPES = {str(d).removeprefix("torch."): d for d in _STORED_AS}


def default_cache_dir() -> str:
    """``$ISPLIB_TPU_TORCH_CACHE_DIR``, else ``~/.cache/isplib_tpu_torch``
    (created on first use)."""
    d = os.environ.get("ISPLIB_TPU_TORCH_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "isplib_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def plan_cache_path(tag: str, cfg: dict,
                    cache_dir: Optional[str] = None) -> str:
    """The cache file of (graph tag, plan configuration)."""
    cache_dir = cache_dir or default_cache_dir()
    key = json.dumps({"fmt": PLAN_FORMAT_VERSION, "tag": tag, **cfg},
                     sort_keys=True)
    h = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"plan_{tag}_{h}.npz")


def graph_fingerprint(arrays: dict, nnz: int) -> str:
    """Content hash of the edges: crc32 over the row pointers and every
    column and value, so two graphs that differ in any edge or edge value
    never share plans (the sum plans hold the values).  The JAX package
    hashes a strided sample of the columns and values, one in
    ``nnz // 65536``; below 131,072 edges its stride is 1 and the two hashes
    agree."""
    rp = arrays.get("rowptr", arrays["row"][:nnz])
    h = zlib.crc32(np.ascontiguousarray(rp).tobytes())
    col = arrays["col"][:nnz]
    if col.shape[0]:
        h = zlib.crc32(np.ascontiguousarray(col).tobytes(), h)
        val = arrays.get("value")
        if val is not None and val.shape[0]:
            h = zlib.crc32(np.ascontiguousarray(val[:nnz]).tobytes(), h)
    return f"{h:08x}"


def _encode(obj, arrays: list):
    """The JSON spec of a plan tree; tensors are appended to ``arrays``."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _STORED_AS:
            raise TypeError(f"plan cache cannot store a {obj.dtype} tensor")
        t = obj.detach().cpu().contiguous()
        bits = t.view(torch.int16) if t.dtype is torch.bfloat16 else t
        arrays.append(bits.numpy())
        return {"t": "tensor", "i": len(arrays) - 1,
                "dtype": str(t.dtype).removeprefix("torch.")}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "v": obj}
    if isinstance(obj, dict):
        return {"t": "dict",
                "v": {k: _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (tuple, list)):
        return {"t": type(obj).__name__,
                "v": [_encode(v, arrays) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        if not cls.__module__.startswith(_MODULE_PREFIX):
            raise TypeError(f"plan cache refuses the dataclass {cls!r}: "
                            f"only {_MODULE_PREFIX}* plans are stored")
        return {"t": "dc", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "v": {f.name: _encode(getattr(obj, f.name), arrays)
                      for f in dataclasses.fields(obj)}}
    raise TypeError(f"plan cache cannot encode {type(obj)!r}")


def _decode(spec, arrays):
    t = spec["t"]
    if t == "none":
        return None
    if t == "tensor":
        dtype = _DTYPES[spec["dtype"]]
        a = arrays[f"a{spec['i']}"]
        if a.dtype != _STORED_AS[dtype]:
            raise ValueError(f"array a{spec['i']} is {a.dtype}, its spec "
                             f"says {spec['dtype']}")
        out = torch.from_numpy(a if a.flags.writeable else np.array(a))
        return out.view(torch.bfloat16) if dtype is torch.bfloat16 else out
    if t == "lit":
        return spec["v"]
    if t == "dict":
        return {k: _decode(v, arrays) for k, v in spec["v"].items()}
    if t in ("tuple", "list"):
        seq = [_decode(v, arrays) for v in spec["v"]]
        return tuple(seq) if t == "tuple" else seq
    if t == "dc":
        mod, _, qual = spec["cls"].partition(":")
        if not mod.startswith(_MODULE_PREFIX):
            raise ValueError(f"refusing to import {mod!r} from the plan "
                             "cache")
        cls = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
        if not dataclasses.is_dataclass(cls):
            raise ValueError(f"{spec['cls']} is not a plan dataclass")
        return cls(**{k: _decode(v, arrays) for k, v in spec["v"].items()})
    raise ValueError(f"unknown plan-cache node type {t!r}")


def save_host_plans(path: str, plans) -> None:
    """Persist a plan tree atomically (tensors copied to the CPU)."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    arrays: list = []
    spec = json.dumps(_encode(plans, arrays)).encode()
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, spec=np.frombuffer(spec, np.uint8),
                     fmt=np.int32(PLAN_FORMAT_VERSION),
                     **{f"a{i}": a for i, a in enumerate(arrays)})
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_host_plans(path: str):
    """The plan tree saved at ``path``, its tensors on the CPU; None on a
    miss.  An entry of another format version, or one that fails to
    decode, is a miss, logged."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            fmt = int(z["fmt"]) if "fmt" in z.files else 2
            if fmt != PLAN_FORMAT_VERSION:
                print(f"[isplib_tpu_torch] plan cache entry {path} is format "
                      f"{fmt}, not {PLAN_FORMAT_VERSION}; rebuilding",
                      file=sys.stderr)
                return None
            spec = json.loads(bytes(z["spec"]).decode())
            return _decode(spec, z)
    except Exception as e:  # noqa: BLE001 - any corruption is a miss
        print(f"[isplib_tpu_torch] plan cache entry {path} failed to decode "
              f"({type(e).__name__}: {str(e)[:80]}); rebuilding",
              file=sys.stderr)
        return None


def tree_to(obj, device: torch.device):
    """A plan tree with every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_to(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj
