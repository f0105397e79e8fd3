"""Dense half of the hybrid SpMM: ``csrc/spmm_bsr.cu`` and its plain version.

Counterpart of ``isplib_tpu/kernels/spmm_bsr2.py::_bsr2_kernel`` (K2).  The
kernel walks the plan's schedule (``HybridPlan.sched``, K9's walk over the
v5 blocks): one CTA per block-row, or per piece of a hub block-row, whose
sum stays in registers and is stored once.  For a CUDA tensor the wrapper
launches the kernel or raises; the plain PyTorch version, with the same
bf16 rounding of x and the blocks, runs only for a CPU tensor (and in
``chip_smoke.py``, which holds the kernel against it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.reference import _SUM_EDGE_FEATURE_BYTES, _chunks
from ..sparse.tiling_v5 import BS, HybridPlan
from ..utils.profiling import span
from . import build

__all__ = ["spmm_bsr", "spmm_bsr_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _check(plan: HybridPlan, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be ({plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != plan.blocks.device:
        raise ValueError(f"x is on {x.device}, the plan on "
                         f"{plan.blocks.device}")


def spmm_bsr_plain(plan: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """The dense half in plain PyTorch: bf16 blocks times bf16-rounded x,
    products and sums in fp32, over chunks of features whose (blocks, 128,
    chunk) temporaries stay within ``CHUNK_BYTES``."""
    k = x.shape[1]
    n_br = plan.n_br
    out = x.new_zeros(n_br * BS, k)
    if plan.nb:
        n_bc = -(-plan.num_cols // BS)
        xb = x.new_zeros(n_bc * BS, k)
        xb[: plan.num_cols] = x.to(torch.bfloat16).float()
        xb = xb.view(n_bc, BS, k)
        blocks = plan.blocks.float()
        br = torch.repeat_interleave(
            torch.arange(n_br, device=x.device),
            plan.blk_rowptr.diff().long())
        for feats in _chunks(plan.nb * BS, k, _SUM_EDGE_FEATURE_BYTES,
                             x.element_size()):
            xg = xb[:, :, feats].index_select(0, plan.blk_col)
            out.view(n_br, BS, k)[:, :, feats].index_add_(
                0, br, torch.bmm(blocks, xg))              # (nb, 128, chunk)
    return out[: plan.num_rows]


@functools.cache
def _lib():
    fn = build.load("spmm_bsr").spmm_bsr_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_bsr(plan: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """``out (num_rows, K) = dense blocks @ x``, fp32, every row written
    (rows without a dense block are 0).

    On CUDA a call is two launches on the current stream, counted as one
    in ``LAUNCHES``: a pre-pass that rounds x to bf16 into a scratch and
    zeroes the block-rows the walk does not store whole, then the walk."""
    global LAUNCHES
    with span("isplib.K2"):
        _check(plan, x)
        if x.device.type == "cpu":
            return spmm_bsr_plain(plan, x)
        if x.device.type != "cuda":
            raise ValueError(f"spmm_bsr runs on cuda or cpu, not {x.device}")
        k = x.shape[1]
        if plan.nb == 0 or k == 0:
            return x.new_zeros(plan.num_rows, k)
        if plan.sched is None:
            raise ValueError("the plan has no K2 schedule: build it with "
                             "build_hybrid_plan")
        s = plan.sched
        out = torch.empty(plan.num_rows, k, dtype=torch.float32,
                          device=x.device)
        xb = torch.empty(-(-plan.num_cols // BS) * BS, -(-k // 8) * 8,
                         dtype=torch.bfloat16, device=x.device)
        err = _lib()(plan.blocks.data_ptr(), s.members.data_ptr(),
                     s.pieces.data_ptr(), s.zero_rbs.data_ptr(), x.data_ptr(),
                     xb.data_ptr(), out.data_ptr(), s.n_pieces,
                     s.zero_rbs.shape[0], plan.num_rows, plan.num_cols,
                     xb.shape[0], k, x.device.index,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"spmm_bsr launch failed: CUDA error {err}")
        LAUNCHES += 1
        return out
