"""The sum-accumulated FusedMM pipeline: ``csrc/fused.cu`` and its plain
version.

Counterpart of ``isplib_tpu/kernels/fused_pallas.py::_fused_kernel`` (K5):
``out[r] = Σ_e s_e · VOP(x[r], y[col e])`` over the CSR edges of row r, with
``s_e = VSC(SOP(ROP(VOP(...))))``, for ``op.aop`` SUM, ``K <= 256`` and
``op.sop`` None or a :class:`~isplib_tpu_torch.ops.semiring.ScalarOp`.  The
kernel is fp32 (split rows add with atomics); its plain version evaluates
the reference formulation in float64.  For a CUDA tensor the wrapper launches the kernel or raises; the plain
version runs only for a CPU tensor (and in ``chip_smoke.py``, which holds
the kernel against it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import reference
from ..ops.semiring import (FusedOp, Reduce, ReduceOp, ScalarOp, ScaleOp,
                            VectorOp)
from ..sparse.tiling_v4mm import MinMaxPlan
from . import build

__all__ = ["fused", "fused_plain", "stage_codes", "MAX_K", "LAUNCHES"]

LAUNCHES = 0  # kernel launches since the count was last set to 0

MAX_K = 256  # a warp's lanes hold the whole feature row: 8 floats a lane


def stage_codes(op: FusedOp) -> tuple[int, int, int, int]:
    """(vop, rop, sop, vsc) as the kernels' integer codes
    (``csrc/fused_ops.cuh``): each enum's declaration order, and for the SOP
    0 = none, then the order of ``ScalarOp``."""
    if not (op.sop is None or isinstance(op.sop, ScalarOp)):
        raise ValueError(f"the FusedMM kernels take sop None or a ScalarOp, "
                         f"not {op.sop!r}")
    sop = 0 if op.sop is None else 1 + list(ScalarOp).index(op.sop)
    return (list(VectorOp).index(VectorOp(op.vop)),
            list(ReduceOp).index(ReduceOp(op.rop)), sop,
            list(ScaleOp).index(ScaleOp(op.vsc)))


def check_operands(plan: MinMaxPlan, col: torch.Tensor,
                   value: torch.Tensor, named: dict) -> None:
    """Shapes of the edge list (at least one edge long: the kernels read
    edge 0's words for an empty segment), and dtype, layout and device of
    every operand; ``named`` maps a name to (tensor, leading dim); all
    share K."""
    need = max(plan.nnz, 1)
    if col.dim() != 1 or col.shape != value.shape or col.shape[0] < need:
        raise ValueError(f"col and value must be one (>= {need},) edge "
                         f"list, got {tuple(col.shape)} and "
                         f"{tuple(value.shape)}")
    k = next(iter(named.values()))[0].shape[-1]
    if k > MAX_K:
        raise ValueError(f"the FusedMM kernels take K <= {MAX_K}, got {k}")
    tensors = {"col": (col, torch.int32), "value": (value, torch.float32)}
    for name, (t, rows) in named.items():
        want = (rows,) if name == "deg" else (rows, k)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        tensors[name] = (t, torch.float32)
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != plan.seg_ptr.device:
            raise ValueError(f"{name} is on {t.device}, the plan on "
                             f"{plan.seg_ptr.device}")


def pad4(t: torch.Tensor) -> torch.Tensor:
    """``t`` (n, K) with zero columns up to K rounded up to a multiple of 4
    (``t`` itself where K is one): the kernels load every row as float4s.
    A zero feature adds 0 to t and to <g, v>, so the first K columns of
    the kernels' result are the unpadded one; :func:`unpad` keeps them."""
    pad = -t.shape[1] % 4
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def unpad(out: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` columns of a kernel's padded output, contiguous."""
    return out if out.shape[1] == k else out[:, :k].contiguous()


def fused_plain(plan: MinMaxPlan, col: torch.Tensor, value: torch.Tensor,
                deg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                op: FusedOp) -> torch.Tensor:
    """The same function in plain PyTorch: the reference formulation over
    the plan's edges, evaluated in float64 and returned in x's type.  In
    fp32 the reference's ``index_add`` over an R-MAT hub row of 10⁵ edges
    strays by up to ~1e-4 of the output's scale, as far as the tolerance
    the kernel is held to; in float64 the oracle's own rounding stays out
    of the comparison."""
    n = plan.nnz
    return reference.fused_mm_raw(
        plan.edge_rows(), col[:n], value[:n].double(), deg.double(),
        x.double(), y.double(), plan.num_rows, op).to(x.dtype)


@functools.cache
def _lib():
    fn = build.load("fused").fused_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused(plan: MinMaxPlan, col: torch.Tensor, value: torch.Tensor,
          deg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
          op: FusedOp) -> torch.Tensor:
    """The pipeline ``op`` (AOP = SUM) over the CSR edges (``col``,
    ``value``; padded, CSR order) cut by ``plan`` (a TiledGraph's
    ``fwd_mm``): x (R, K), y (C, K), deg (R,) float32 → (R, K) float32."""
    global LAUNCHES
    if Reduce(op.aop) is not Reduce.SUM:
        raise ValueError(f"the FusedMM kernel accumulates by sum, not "
                         f"{op.aop}")
    codes = stage_codes(op)
    check_operands(plan, col, value, {"x": (x, plan.num_rows),
                                      "y": (y, plan.num_cols),
                                      "deg": (deg, plan.num_rows)})
    if x.device.type == "cpu":
        return fused_plain(plan, col, value, deg, x, y, op)
    if x.device.type != "cuda":
        raise ValueError(f"fused runs on cuda or cpu, not {x.device}")
    k = x.shape[1]
    x, y = pad4(x), pad4(y)
    out = torch.empty(plan.num_rows, x.shape[1], dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out[:, :k]
    err = _lib()(plan.seg_ptr.data_ptr(), plan.seg_row.data_ptr(),
                 plan.seg_slot.data_ptr(), plan.split_rows.data_ptr(),
                 col.data_ptr(), value.data_ptr(), deg.data_ptr(),
                 x.data_ptr(), y.data_ptr(), out.data_ptr(), plan.nseg,
                 plan.nsplit, x.shape[1], *codes, x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused launch failed: CUDA error {err}")
    LAUNCHES += 1
    return unpad(out, k)
