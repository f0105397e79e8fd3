"""Parameter conversion from the JAX package's flax models.

Each function takes the flax variables as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and returns a state_dict
for the port's model; load it with ``model.load_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gcn_params_from_flax", "sage_params_from_flax",
           "gin_params_from_flax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def gcn_params_from_flax(params) -> dict[str, torch.Tensor]:
    """A ``GCN`` state_dict from the flax ``GCN`` params
    ``{"conv1": {"kernel", "bias"}, "conv2": {...}}``."""
    return {f"{layer}.{name}": _t(params[layer][name])
            for layer in ("conv1", "conv2") for name in ("kernel", "bias")}


def sage_params_from_flax(params) -> dict[str, torch.Tensor]:
    """A ``GraphSAGE`` state_dict from the flax ``GraphSAGE`` params
    ``{"conv{1,2}": {"lin_l": {"kernel", "bias"}, "lin_r": {"kernel"}}}``."""
    out = {}
    for layer in ("conv1", "conv2"):
        p = params[layer]
        out[f"{layer}.lin_l.kernel"] = _t(p["lin_l"]["kernel"])
        out[f"{layer}.lin_l.bias"] = _t(p["lin_l"]["bias"])
        out[f"{layer}.lin_r.kernel"] = _t(p["lin_r"]["kernel"])
    return out


def gin_params_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """A ``GIN`` state_dict from the flax ``GIN`` params (``conv{1,2}`` →
    ``_GINMLP_0`` → ``Dense_{0,1}``, ``bn{1,2}`` {scale, bias},
    ``fc{1,2}``) and its ``batch_stats`` (``bn{1,2}`` {mean, var})."""
    out = {}
    for layer in ("conv1", "conv2"):
        mlp = params[layer]["_GINMLP_0"]
        for i in (0, 1):
            for name in ("kernel", "bias"):
                out[f"{layer}.mlp.dense_{i}.{name}"] = _t(
                    mlp[f"Dense_{i}"][name])
    for bn in ("bn1", "bn2"):
        out[f"{bn}.scale"] = _t(params[bn]["scale"])
        out[f"{bn}.bias"] = _t(params[bn]["bias"])
        out[f"{bn}.mean"] = _t(batch_stats[bn]["mean"])
        out[f"{bn}.var"] = _t(batch_stats[bn]["var"])
    for fc in ("fc1", "fc2"):
        for name in ("kernel", "bias"):
            out[f"{fc}.{name}"] = _t(params[fc][name])
    return out
