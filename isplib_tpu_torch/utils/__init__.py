"""Utilities of the port: device timing (``timing.chain_time``,
``chain_times``), profiling (``profiling.trace``, ``op_report``,
``Timer``) and the H100's cost model of the sum plans (``roofline``)."""

from .timing import chain_time, chain_times
from .profiling import Timer, op_report, trace

__all__ = ["chain_time", "chain_times", "trace", "op_report", "Timer"]
