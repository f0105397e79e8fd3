"""Profiling, the counterpart of ``isplib_tpu.utils.profiling``: a profiler
trace, a per-op timing report, and the port's one tracing system.

``trace`` runs ``torch.profiler`` (with CUDA activity when a card is
present) and writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``.

The port names its own work in two ways:

* ``span(name)``, for the hot path (kernel wrappers, the training step): a
  profiler range while a profiler runs, so the range sits on the
  profiler's timeline beside the device operations it launched; with no
  profiler running, one read of a flag and a shared null context, and
  nothing recorded.  The range is torch's ``_RecordFunctionFast`` (the
  range the compiler's Triton launches open), an operator's scope: the
  profiler links a kernel launched outside ATen (the port's kernels,
  through ``ctypes``) to the innermost operator-scope range open at its
  launch, and never to a ``record_function`` range, a user scope.
* ``stage(name, **attrs)``, for set-up work of milliseconds to seconds
  (graph builds, transforms, plans): always recorded, as one record
  ``{id, parent, name, t0_ns, t1_ns, attrs}`` in a process-wide log on the
  ``time.perf_counter_ns`` clock, its parent the stage open on the same
  thread when it began; the log keeps the newest ``STAGE_LOG_LIMIT`` and
  counts what it drops (``stages()``, ``dropped_stages()``,
  ``clear_stages()``).  While a profiler runs a stage also opens its
  range.  A stage does not synchronise the card.

``Timer.section(name, sync=...)`` is a stage whose seconds the timer also
sums per name; with ``sync`` it synchronises the card before the clock
stops, so a section covers the device work queued in it (the JAX package's
``drain`` is not needed for that).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "op_report", "Timer", "span", "stage", "stages",
           "clear_stages", "dropped_stages", "STAGE_LOG_LIMIT"]

STAGE_LOG_LIMIT = 4096


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
    from .timing import chain_time
    return {name: chain_time(fn, x0, iters)
            for name, (fn, x0) in named_fns.items()}


# ---------------------------------------------------------------------------
# Hot-path ranges
# ---------------------------------------------------------------------------

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled

_NULL = contextlib.nullcontext()


def _range(name: str):
    """A profiler range that owns the kernels launched inside it."""
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else the
    shared null context (no range entered, nothing allocated)."""
    if not _profiling():
        return _NULL
    return _range(name)


# ---------------------------------------------------------------------------
# Set-up stages
# ---------------------------------------------------------------------------

_LOG: collections.deque = collections.deque(maxlen=STAGE_LOG_LIMIT)
_DROPPED = [0]
_IDS = itertools.count()
_OPEN = threading.local()


def _open_stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Stage:
    """One stage while it runs: ``attrs`` may be added to in the body, and
    ``seconds`` holds its length once it has ended."""

    __slots__ = ("record", "attrs", "seconds", "_sync", "_sums", "_range")

    def __init__(self, name: str, attrs: dict, sync=None,
                 sums: Optional[dict] = None):
        self.record = dict(id=None, parent=None, name=name, t0_ns=None,
                           t1_ns=None, attrs=attrs)
        self.attrs = attrs
        self.seconds = None
        self._sync, self._sums, self._range = sync, sums, None

    def __enter__(self) -> "_Stage":
        stack = _open_stack()
        rec = self.record
        rec["id"] = next(_IDS)
        rec["parent"] = stack[-1].record["id"] if stack else None
        if len(_LOG) == _LOG.maxlen:
            _DROPPED[0] += 1
        _LOG.append(rec)
        stack.append(self)
        if _profiling():
            self._range = _range(rec["name"])
            self._range.__enter__()
        rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        try:
            dev = (self._sync.device if isinstance(self._sync, torch.Tensor)
                   else self._sync)
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            rec = self.record
            rec["t1_ns"] = time.perf_counter_ns()
            self.seconds = (rec["t1_ns"] - rec["t0_ns"]) / 1e9
            if self._range is not None:
                self._range.__exit__(*exc)
            _open_stack().pop()
            if self._sums is not None:
                self._sums[rec["name"]] = (self._sums.get(rec["name"], 0.0)
                                           + self.seconds)


def stage(name: str, **attrs) -> _Stage:
    """A set-up stage named ``name`` with attributes ``attrs`` (numbers,
    strings, small dicts), as a context manager that yields the running
    stage."""
    return _Stage(name, attrs)


def stages() -> list[dict]:
    """A copy of the stage log, oldest first (an open stage's ``t1_ns`` is
    None)."""
    return [dict(r, attrs=dict(r["attrs"])) for r in list(_LOG)]


def dropped_stages() -> int:
    """Records the log dropped, oldest first, to stay within its limit."""
    return _DROPPED[0]


def clear_stages() -> None:
    """Empty the log and its count of dropped records."""
    _LOG.clear()
    _DROPPED[0] = 0


class Timer:
    """Named wall-clock sections, summed per name, with a JSON report; each
    section is also a stage of the log."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    def section(self, name: str, sync=None, **attrs) -> _Stage:
        """Time the body as the stage ``name``; with ``sync`` (a tensor or
        a device) on CUDA the card is synchronised before the clock
        stops."""
        return _Stage(name, attrs, sync, self.sections)

    def report(self) -> str:
        return json.dumps(self.sections, indent=1)
