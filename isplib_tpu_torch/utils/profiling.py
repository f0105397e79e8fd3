"""Profiling, the counterpart of ``isplib_tpu.utils.profiling``: a profiler
trace, a per-op timing report and named wall-clock sections.

``trace`` runs ``torch.profiler`` (with CUDA activity when a card is
present) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``.  ``Timer.section(name, sync=...)`` synchronises the
card before it stops the clock, so a section covers the device work queued
in it; the JAX package's ``drain`` is not needed for that.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from .timing import chain_time

__all__ = ["trace", "op_report", "Timer"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body and write its Chrome trace as
    ``trace_<pid>_<ns>.json`` into ``log_dir`` (default: a directory
    ``isplib_tpu_torch_trace`` under the temporary directory); yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "isplib_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def op_report(named_fns: dict[str, tuple[Callable, torch.Tensor]],
              iters: int = 20) -> dict[str, float]:
    """Seconds per call of each ``name -> (chainable_fn, x0)``, timed with
    ``utils.timing.chain_time`` (the card's clock for a CUDA ``x0``)."""
    return {name: chain_time(fn, x0, iters)
            for name, (fn, x0) in named_fns.items()}


class Timer:
    """Named wall-clock sections, summed per name, with a JSON report."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the body; with ``sync`` (a tensor or a device) on CUDA the
        card is synchronised before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dev = sync.device if isinstance(sync, torch.Tensor) else sync
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            self.sections[name] = (self.sections.get(name, 0.0)
                                   + time.perf_counter() - t0)

    def report(self) -> str:
        return json.dumps(self.sections, indent=1)
