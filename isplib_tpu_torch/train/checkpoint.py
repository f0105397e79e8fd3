"""Checkpoints, the counterpart of ``isplib_tpu.train.checkpoint``.

One file per step, ``step_<N>.pt`` under the checkpoint directory, written
with ``torch.save`` to a temporary file in the same directory and moved into
place with ``os.replace``, so a reader sees a whole checkpoint or none.  As
the JAX package's orbax manager does, only the newest ``max_to_keep`` steps
are kept.  ``params`` is a ``state_dict()`` (a model's holds its BatchNorm
statistics too), ``opt_state`` an ``optimizer.state_dict()``; the restored
dict has the JAX package's keys (``params``, and ``opt_state``,
``batch_stats``, ``extra`` where saved).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from ..device import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> list[int]:
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, names) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_checkpoint(ckpt_dir: str, step: int, params: Any,
                    opt_state: Any = None, batch_stats: Any = None,
                    extra: Optional[dict] = None,
                    max_to_keep: int = 3) -> None:
    """Write step ``step`` atomically, then delete all but the newest
    ``max_to_keep`` steps.  Every value is a tensor, or a dict, list or
    tuple of them and of plain Python values (``restore_checkpoint`` loads
    with ``weights_only``)."""
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra:
        state["extra"] = extra
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _path(ckpt_dir, step)
    tmp = f"{final}.tmp{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest saved step, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(value, template):
    """``value`` with each tensor cast to the dtype and device of the tensor
    at the same place in ``template``."""
    if isinstance(template, torch.Tensor):
        return value.to(dtype=template.dtype, device=template.device)
    if isinstance(template, dict):
        if set(template) != set(value):
            raise KeyError(f"checkpoint keys {sorted(map(str, value))} do "
                           f"not match the template's "
                           f"{sorted(map(str, template))}")
        return {k: _like(value[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, t) for v, t in zip(value, template))
    return value


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       template: Any = None,
                       device: str | torch.device = "cuda") -> dict:
    """Load step ``step`` (the newest when None) onto ``device``.  With
    ``template`` (a dict shaped like the restored one, e.g. ``{"params":
    model.state_dict()}``) each tensor takes the dtype and device of its
    counterpart there, and a key missing on either side raises.  Raises
    ``FileNotFoundError`` when there is no such step."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None or not os.path.exists(_path(ckpt_dir, step)):
        raise FileNotFoundError(f"no checkpoint {step} in {ckpt_dir}"
                                if step is not None
                                else f"no checkpoints in {ckpt_dir}")
    out = torch.load(_path(ckpt_dir, step),
                     map_location=resolve_device(device), weights_only=True)
    if template is not None:
        out = {**out, **_like({k: out[k] for k in template}, template)}
    return out
