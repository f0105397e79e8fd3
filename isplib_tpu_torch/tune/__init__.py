"""The measured SpMM autotuner (``autotune.tune_spmm``) and its cache."""

from . import autotune
from .autotune import tune_spmm

__all__ = ["autotune", "tune_spmm"]
