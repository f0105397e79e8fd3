"""Dense half of the v3 hybrid SpMM: ``csrc/spmm_bsr_v3.cu`` and its plain
version.

Counterpart of ``isplib_tpu/kernels/spmm_bsr.py::_bsr_kernel`` (K9, entries
``spmm_bsr`` and ``spmm_hybrid``), over the celled ``BSRPlan`` of
``build_tiling(version=3)``.  (The port's ``kernels/spmm_bsr`` is K2, the v5
dense half.)  x is rounded to bf16 as the TPU kernel rounds it, and the
products are summed in fp32.  The v3 hybrid's residual half (K8) adds into
the output.  For a CUDA tensor the wrapper launches the kernel or raises;
the plain version runs only for a CPU tensor (and in ``chip_smoke.py``,
which holds the kernel against it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sparse.tiling_v3 import BS, BSRPlan
from . import build

__all__ = ["spmm_bsr_v3", "spmm_bsr_v3_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0

_MEMBERS_PER_PASS = 512  # blocks multiplied at once by the plain version


def _check(plan: BSRPlan, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.device}")


def spmm_bsr_v3_plain(plan: BSRPlan, x: torch.Tensor) -> torch.Tensor:
    """The dense half in plain PyTorch: each member's bf16 block times the
    bf16-rounded x tile of its cell, products and sums in fp32, added into
    its row block: ``(num_rows, K)``."""
    k, g, n_bc = x.shape[1], plan.g, plan.n_bc
    out = x.new_zeros(plan.r_padded, k)
    xb = x.new_zeros(plan.c_padded, k)
    xb[: plan.num_cols] = x.to(torch.bfloat16).float()
    xb = xb.view(n_bc, BS, k)
    n_groups = plan.nb // g
    groups = torch.arange(n_groups, device=x.device, dtype=torch.int32)
    cell = torch.searchsorted(plan.cell_starts[:-1].contiguous(), groups,
                              right=True).long() - 1
    # member m = b*g + j: its cell and its row block
    cell_m = cell.repeat_interleave(g)
    rblock = (cell_m // n_bc) * plan.nrb_s + plan.rb_locals.long()
    step = max(1, _MEMBERS_PER_PASS // g)
    for b0 in range(0, n_groups, step):
        b1 = min(b0 + step, n_groups)
        # (members, c, r): member j of group b is lane band j
        blk = (plan.blocks[b0:b1].view(b1 - b0, BS, g, BS)
               .permute(0, 2, 1, 3).reshape(-1, BS, BS).float())
        m = slice(b0 * g, b1 * g)
        prod = torch.bmm(blk.transpose(1, 2),
                         xb.index_select(0, cell_m[m] % n_bc))
        out.view(-1, BS, k).index_add_(0, rblock[m], prod)
    return out[: plan.num_rows]


@functools.cache
def _lib():
    fn = build.load("spmm_bsr_v3").spmm_bsr_v3_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_bsr_v3(plan: BSRPlan, x: torch.Tensor) -> torch.Tensor:
    """``out (num_rows, K) = dense blocks @ x``, fp32."""
    global LAUNCHES
    _check(plan, x)
    if x.device.type == "cpu":
        return spmm_bsr_v3_plain(plan, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_bsr_v3 runs on cuda or cpu, not {x.device}")
    k = x.shape[1]
    out = torch.zeros(plan.num_rows, k, dtype=torch.float32, device=x.device)
    if plan.nb == 0 or k == 0:
        return out
    err = _lib()(plan.blocks.data_ptr(), plan.rb_locals.data_ptr(),
                 plan.cell_starts.data_ptr(), x.data_ptr(), out.data_ptr(),
                 plan.nb // plan.g, plan.n_cells, plan.n_bc, plan.nrb_s,
                 plan.g, plan.num_rows, plan.num_cols, k, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"spmm_bsr_v3 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
