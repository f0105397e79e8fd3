from .semiring import (FusedOp, Reduce, ReduceOp, ScalarOp, ScaleOp,
                       VectorOp)
from . import reference
from .spmm import SDDMM, SpMM, sddmm, set_default_backend, spmm
from .fused import FusedMM, fused_mm, fused_mm_edges
from .attention import attention

__all__ = ["Reduce", "VectorOp", "ReduceOp", "ScalarOp", "ScaleOp",
           "FusedOp", "reference", "SpMM", "spmm", "SDDMM", "sddmm",
           "FusedMM", "fused_mm", "fused_mm_edges", "set_default_backend",
           "attention"]
