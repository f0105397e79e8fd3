"""Utilities of the port: device timing (``timing.chain_time``) and
profiling (``profiling.trace``, ``op_report``, ``Timer``)."""

from .timing import chain_time
from .profiling import Timer, op_report, trace

__all__ = ["chain_time", "trace", "op_report", "Timer"]
