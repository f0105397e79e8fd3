"""The H100's peaks and the plan-aware cost model of the port's sum plans,
the counterpart of the JAX system's ``bench.py`` (``device_peaks``,
``_v2_cost``, ``_bsr_cost``, ``_v5_cost``, ``plan_bound_edges_per_s``,
``gather_roofline_edges_per_s``).

A bound is the least time the card could take for a call: the larger of
the bytes the call must move over the HBM rate and its operations over the
peak rate of their type (an FMA counts as 2).  The model counts the work of
this card's kernels, not the TPU's one-hot matmuls: each input is read
once, each output written once, and only what the plan's data needs:

* K2 (``HybridPlan``'s dense half): the bf16 blocks, the block-row
  pointers and block columns; 2·128²·K operations a block on the bf16
  tensor cores;
* K1 (its residual half): 8 B an edge, the row pointers and the segments;
  2·K fp32 operations an edge;
* K9 (``HybridPlanV3``'s dense half): the real members' bf16 blocks, the
  members' row-block words and the cell table; 2·128²·K a member on the
  tensor cores;
* K8 (``TiledPlanV2``; v3's residual half): the real edges' planes, 4 B
  each, and as a whole plan the x tile of every non-empty cell; 2·K fp32
  an edge;
* K10 (``TiledPlan``): 12 B a real edge, the chunk tables and the x rows
  read; 2·K fp32 an edge.

A plan of two halves (versions 5, 4 and 3) costs each kernel's bytes plus
x and the output once; its operations take the longer of the tensor cores'
time and fp32's.  A plan of one kernel (versions 2 and 1) costs that
kernel's call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..sparse.tiling import TiledPlan
from ..sparse.tiling_v2 import TiledPlanV2
from ..sparse.tiling_v3 import HybridPlanV3
from ..sparse.tiling_v5 import HybridPlan

__all__ = ["HBM_BYTES_PER_S", "BF16_TENSOR_FLOPS", "FP32_FLOPS", "Peaks",
           "H100_SXM", "device_peaks", "bound_ms", "cost_bound_ms",
           "plan_cost", "v2_cost", "plan_bound_edges_per_s",
           "gather_roofline_edges_per_s"]

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12    # dense bf16 tensor-core peak
FP32_FLOPS = 67e12            # fp32 outside the tensor cores

_BLOCK = 128 * 128


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's published peaks, at its full power limit."""

    hbm_bytes_per_s: float
    bf16_flops: float
    fp32_flops: float


# NVIDIA's data sheet, SXM part, dense rates at 700 W
H100_SXM = Peaks(HBM_BYTES_PER_S, BF16_TENSOR_FLOPS, FP32_FLOPS)

# by ``torch.cuda.get_device_name``: a PCIe H100 has other peaks
_PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def device_peaks(device: str | torch.device = "cuda") -> Peaks:
    """The peaks of the card ``device`` names, looked up by its name; a
    card not in the table raises and names the card.  On ``"cpu"`` the
    H100 SXM's peaks, so that the cost arithmetic runs without a card (a
    bound computed so says what an H100 could do, not what the CPU can)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return H100_SXM
    name = torch.cuda.get_device_name(dev)
    if name not in _PEAKS:
        raise ValueError(f"no peaks are known for the card {name!r}; the "
                         f"table holds {sorted(_PEAKS)}")
    return _PEAKS[name]


def cost_bound_ms(nbytes: float, op_seconds: float) -> tuple[float, str]:
    """(milliseconds, "bytes" or "operations") of a cost on the H100: the
    larger of the bytes' time and the operations' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= op_seconds:
        return t_bytes * 1e3, "bytes"
    return op_seconds * 1e3, "operations"


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The bound of ``nbytes`` moved and ``ops`` operations at ``peak``
    operations a second."""
    return cost_bound_ms(nbytes, ops / peak)


def _blocks_work(plan: HybridPlan, k: int) -> tuple[float, float, float]:
    """(bytes, bf16 operations, fp32 operations) of K2, x and the output
    left out."""
    return (plan.nb * _BLOCK * 2 + (plan.n_br + 1 + plan.nb) * 4,
            2.0 * plan.nb * _BLOCK * k, 0.0)


def _residual_work(plan: HybridPlan, k: int) -> tuple[float, float, float]:
    """K1's, x and the output left out."""
    return (plan.sparse_edges * 8 + (plan.num_rows + 1) * 4
            + (2 * plan.nseg + 1) * 4, 0.0, 2.0 * plan.sparse_edges * k)


def _members_work(plan, k: int) -> tuple[float, float, float]:
    """K9's (a ``BSRPlan`` with its schedule), x and the output left out."""
    members = plan.sched.n_real
    return (members * _BLOCK * 2 + (plan.nb + plan.n_cells + 1) * 4,
            2.0 * members * _BLOCK * k, 0.0)


def _real_slots(plan: TiledPlanV2) -> int:
    """The real edges of a v2 plan: slots with an edge id, or (without
    ids) with a value other than 0."""
    e = plan.edges[:plan.nc]
    if plan.with_eids:
        return int((e[:, 3] >= 0).sum())
    return int((e[:, 1].view(torch.float32) != 0).sum())


def _v2_work(plan: TiledPlanV2, k: int) -> tuple[float, float, float]:
    """K8's, x and the output left out."""
    real = _real_slots(plan)
    return real * plan.planes * 4, 0.0, 2.0 * real * k


def v2_cost(plan: TiledPlanV2, k: int, out_bytes_per: int = 4,
            peaks: Peaks = H100_SXM) -> tuple[float, float]:
    """(bytes, operation seconds) of one K8 or K7 call on a v2 plan: the
    real edges' planes, the x tile of every non-empty cell, and the
    (R, K) outputs of ``out_bytes_per`` bytes an entry (4 for K8's sum, 8
    for K7's values and winning ids)."""
    nbytes, _, ops = _v2_work(plan, k)
    cells = torch.nonzero(plan.cell_starts.diff() > 0).flatten()
    c0 = (cells % plan.nct) * plan.ct
    tile_rows = int((plan.num_cols - c0).clamp(max=plan.ct).sum())
    nbytes += tile_rows * k * 4 + plan.num_rows * k * out_bytes_per
    return nbytes, ops / peaks.fp32_flops


def _v1_cost(plan: TiledPlan, k: int, peaks: Peaks) -> tuple[float, float]:
    s = plan.slots()
    cols = s["col"][s["val"] != 0]
    real = int(cols.numel())
    x_rows = int(torch.unique(cols).numel())
    nbytes = (real * 12 + plan.nc * 8 + (plan.nrb + 1) * 4 + x_rows * k * 4
              + plan.num_rows * k * 4)
    return nbytes, 2.0 * real * k / peaks.fp32_flops


def plan_cost(plan, k: int, peaks: Peaks = H100_SXM) -> tuple[float, float]:
    """(bytes, operation seconds) of one sum-SpMM at width ``k`` through
    ``plan``, of any version (the module docstring's counts)."""
    if isinstance(plan, TiledPlanV2):
        return v2_cost(plan, k, peaks=peaks)
    if isinstance(plan, TiledPlan):
        return _v1_cost(plan, k, peaks)
    if isinstance(plan, HybridPlan):
        parts = [_blocks_work(plan, k), _residual_work(plan, k)]
    elif isinstance(plan, HybridPlanV3):
        parts = ([_members_work(plan.bsr, k)] if plan.bsr is not None
                 else []) + ([_v2_work(plan.residual, k)]
                             if plan.residual is not None else [])
    else:
        raise TypeError(f"no cost model for a {type(plan).__name__}")
    nbytes = (sum(b for b, _, _ in parts)
              + (plan.num_cols + plan.num_rows) * k * 4)
    op_seconds = max(sum(o for _, o, _ in parts) / peaks.bf16_flops,
                     sum(o for _, _, o in parts) / peaks.fp32_flops)
    return nbytes, op_seconds


def plan_bound_edges_per_s(tiled, k: int,
                           device: str | torch.device = "cuda") -> float:
    """The plan-aware bound of ``tiled``'s forward sum-SpMM at width
    ``k``: ``nnz / max(bytes / HBM rate, operation seconds)`` of
    ``tiled.fwd`` at the peaks of ``device``'s card."""
    peaks = device_peaks(device)
    nbytes, op_seconds = plan_cost(tiled.fwd, k, peaks)
    return tiled.nnz / max(nbytes / peaks.hbm_bytes_per_s, op_seconds)


def gather_roofline_edges_per_s(k: int, bw: float = HBM_BYTES_PER_S
                                ) -> float:
    """The plan-independent yardstick: one K-vector gather and 8 B of
    edge words an edge (logged for context only)."""
    return bw / (k * 4 + 8)
