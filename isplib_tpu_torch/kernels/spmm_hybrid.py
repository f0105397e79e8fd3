"""Sum/mean SpMM over a TiledGraph: the dense half, then the residual half
added into it.

Counterpart of ``isplib_tpu/kernels/spmm_pallas.py:219-281``
(``spmm_forward`` / ``spmm_transpose_sum`` over a v5 plan).  Max/min run
their own kernel (``spmm_minmax_v4``), which ``ops/spmm.py`` dispatches.
"""

from __future__ import annotations

import torch

from ..ops.semiring import Reduce
from ..sparse.tiling import TiledGraph
from ..sparse.tiling_v5 import HybridPlan
from .spmm_bsr import spmm_bsr
from .spmm_stream import spmm_stream

__all__ = ["spmm_hybrid", "spmm_forward", "spmm_transpose_sum"]


def spmm_hybrid(plan: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """Sum-SpMM of one plan: ``blocks @ x + residual @ x``, fp32."""
    x = x.contiguous()
    out = spmm_bsr(plan, x)
    spmm_stream(plan, x, out)
    return out


def spmm_forward(graph: TiledGraph, x: torch.Tensor,
                 reduce: Reduce) -> torch.Tensor:
    """``spmm(A, x)`` for sum or mean through the forward plan."""
    if reduce not in (Reduce.SUM, Reduce.MEAN):
        raise ValueError(f"the hybrid kernels reduce sum or mean, not "
                         f"{reduce.value}")
    out = spmm_hybrid(graph.fwd, x)
    if reduce is Reduce.MEAN:
        out = out / graph.graph.deg.clamp(min=1.0)[:, None]
    return out


def spmm_transpose_sum(graph: TiledGraph, g: torch.Tensor) -> torch.Tensor:
    """``grad_x = spmm(Aᵀ, g)`` through the transpose plan."""
    return spmm_hybrid(graph.bwd, g)
