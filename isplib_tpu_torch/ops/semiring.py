"""Semiring and fused-op specification, the counterpart of
``isplib_tpu.ops.semiring``.

``Reduce`` is the SpMM reduction.  ``FusedOp`` selects the 5-stage FusedMM
pipeline (the reference's ``imsg`` bitfield, ``fusedMM.h:8-74``):

    VOP  (vector op on x_row, y_col)  → per-edge vector
    ROP  (reduce vector to scalar)    → per-edge scalar
    SOP  (scalar op, e.g. sigmoid)    → per-edge scalar
    VSC  (scale: ×value or ÷degree)   → per-edge contribution
    AOP  (accumulate into output row) → reduction semiring

with the same enums, names and values as the JAX package.

**The SOP contract.**  In the JAX package ``sop`` is any traced callable.
A compiled CUDA kernel cannot take one, so in the port ``sop`` is ``None``
or a member of :class:`ScalarOp`, a catalogue that the FusedMM kernels
(``kernels/csrc/fused.cu`` and ``fused_bwd.cu``) compile in, each member
with its derivative.  A member is also callable on a tensor, so the plain
formulation uses the same object.  Any other Python callable is accepted
too, and then ``fused_mm`` runs the plain, differentiable formulation
(``ops/reference.py``), as the JAX package sends what its kernel cannot
take to XLA.  The route depends only on the op's type, never on a failed
build or launch.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import torch

__all__ = ["Reduce", "VectorOp", "ReduceOp", "ScalarOp", "ScaleOp",
           "FusedOp"]


class Reduce(str, enum.Enum):
    """Output accumulation semiring: sum, mean (sum over max(deg, 1)), max
    and min."""
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"

    @classmethod
    def of(cls, x) -> "Reduce":
        if isinstance(x, Reduce):
            return x
        return cls(str(x).lower())


class VectorOp(str, enum.Enum):
    """Per-edge vector op on (x_dst, y_src) (reference VOP)."""
    COPY_RHS = "copy_rhs"   # message = y[col]   (plain SpMM)
    COPY_LHS = "copy_lhs"   # message = x[row]
    ADD = "add"
    SUB = "sub"
    MUL = "mul"             # hadamard: with DOT, <x_i, y_j>
    MAX = "max"
    MIN = "min"


class ReduceOp(str, enum.Enum):
    """Per-edge vector→scalar reduction (reference ROP)."""
    NOOP = "noop"           # no scalar: t = 1
    DOT = "dot"             # sum over features
    NORM2 = "norm2"         # squared L2 of the VOP output


class ScaleOp(str, enum.Enum):
    """Per-edge scaling (reference VSC)."""
    MUL = "mul"             # × edge value
    MEAN = "mean"           # × edge value / max(row degree, 1)
    NONE = "none"


class ScalarOp(str, enum.Enum):
    """The SOP catalogue that the FusedMM kernels compile in: the two
    SOP_UDEF functions of the reference's embedding kernels
    (``fusedMM.h:45-52``).  ``op(t)`` applies it to a tensor and
    ``op.grad(t)`` is its derivative."""
    SIGMOID = "sigmoid"     # 1 / (1 + e^-t);  derivative s(1 - s)
    TDIST = "tdist"         # 1 / (1 + t);     derivative -1 / (1 + t)²

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self is ScalarOp.SIGMOID:
            return torch.sigmoid(t)
        return 1.0 / (1.0 + t)

    def grad(self, t: torch.Tensor) -> torch.Tensor:
        s = self(t)
        if self is ScalarOp.SIGMOID:
            return s * (1.0 - s)
        return -(s * s)


@dataclasses.dataclass(frozen=True)
class FusedOp:
    """Full 5-stage fused SDDMM+SpMM pipeline spec.  ``sop`` is ``None``, a
    :class:`ScalarOp` (the kernels' catalogue) or any elementwise torch
    callable (the plain formulation)."""
    vop: VectorOp = VectorOp.COPY_RHS
    rop: ReduceOp = ReduceOp.NOOP
    sop: Optional[Callable] = None
    vsc: ScaleOp = ScaleOp.MUL
    aop: Reduce = Reduce.SUM

    @classmethod
    def spmm(cls, reduce: Reduce | str) -> "FusedOp":
        r = Reduce.of(reduce)
        vsc = ScaleOp.MEAN if r is Reduce.MEAN else ScaleOp.MUL
        aop = Reduce.SUM if r in (Reduce.SUM, Reduce.MEAN) else r
        return cls(vop=VectorOp.COPY_RHS, rop=ReduceOp.NOOP, sop=None,
                   vsc=vsc, aop=aop)

    @classmethod
    def sddmm_dot(cls) -> "FusedOp":
        """Per-edge dot product <x_row, y_col>."""
        return cls(vop=VectorOp.MUL, rop=ReduceOp.DOT, sop=None,
                   vsc=ScaleOp.NONE, aop=Reduce.SUM)
