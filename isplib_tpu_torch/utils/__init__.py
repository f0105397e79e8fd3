"""Utilities of the port: device timing (``timing.chain_time``)."""

from .timing import chain_time

__all__ = ["chain_time"]
