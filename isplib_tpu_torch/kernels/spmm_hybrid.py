"""Sum/mean SpMM over a TiledGraph, dispatched by the type of its plans.

Counterpart of ``isplib_tpu/kernels/spmm_pallas.py:219-281`` (``_run_plan``,
``spmm_forward``, ``spmm_transpose_sum``):

* ``HybridPlan`` (versions 5 and 4): the dense half (K2), then the residual
  half (K1) added into it; a version-4 plan has no dense block, so only K1
  launches;
* ``HybridPlanV3`` (version 3): the celled dense blocks (K9), then the v2
  residual (K8) added into the same output;
* ``TiledPlanV2`` (version 2): K8;
* ``TiledPlan`` (version 1): K10.

Max/min run their own kernel (``spmm_minmax_v4``), which ``ops/spmm.py``
dispatches, as it dispatches a forward-only tiling's ``grad_x`` to the
reference transpose path.
"""

from __future__ import annotations

import torch

from ..ops.semiring import Reduce
from ..sparse.tiling import TiledGraph, TiledPlan
from ..sparse.tiling_v2 import TiledPlanV2
from ..sparse.tiling_v3 import HybridPlanV3
from ..sparse.tiling_v5 import HybridPlan
from .spmm_bsr import spmm_bsr
from .spmm_bsr_v3 import spmm_bsr_v3
from .spmm_rowblock import spmm_rowblock
from .spmm_stream import spmm_stream
from .spmm_v2 import spmm_v2

__all__ = ["spmm_hybrid", "run_plan", "spmm_forward", "spmm_transpose_sum"]


def spmm_hybrid(plan: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """Sum-SpMM of one plan: ``blocks @ x + residual @ x``, fp32."""
    x = x.contiguous()
    out = spmm_bsr(plan, x)
    spmm_stream(plan, x, out)
    return out


def run_plan(plan, x: torch.Tensor) -> torch.Tensor:
    """Sum-SpMM of a plan of any version: ``(num_rows, K)`` fp32."""
    if isinstance(plan, HybridPlan):
        return spmm_hybrid(plan, x)
    x = x.contiguous()
    if isinstance(plan, HybridPlanV3):
        out = None
        if plan.bsr is not None:
            out = spmm_bsr_v3(plan.bsr, x)
        if plan.residual is not None:
            out = spmm_v2(plan.residual, x, out)
        if out is None:
            out = x.new_zeros(plan.num_rows, x.shape[1])
        return out
    if isinstance(plan, TiledPlanV2):
        return spmm_v2(plan, x)
    if isinstance(plan, TiledPlan):
        return spmm_rowblock(plan, x)
    raise TypeError(f"no sum kernel runs a {type(plan).__name__}")


def spmm_forward(graph: TiledGraph, x: torch.Tensor,
                 reduce: Reduce) -> torch.Tensor:
    """``spmm(A, x)`` for sum or mean through the forward plan."""
    if reduce not in (Reduce.SUM, Reduce.MEAN):
        raise ValueError(f"the sum kernels reduce sum or mean, not "
                         f"{reduce.value}")
    out = run_plan(graph.fwd, x)
    if reduce is Reduce.MEAN:
        out = out / graph.graph.deg.clamp(min=1.0)[:, None]
    return out


def spmm_transpose_sum(graph: TiledGraph, g: torch.Tensor) -> torch.Tensor:
    """``grad_x = spmm(Aᵀ, g)`` through the transpose plan (the graph must
    have one: ``bwd`` is not None)."""
    return run_plan(graph.bwd, g)
