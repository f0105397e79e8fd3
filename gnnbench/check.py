"""The comparison that decides ``correct``: what the timed path produced in
its first steps against the plain reference's same steps.

Three numbers, each against a limit of the cell's (``limits/<cell>.json``):

* ``loss_gap``: the largest |loss − reference loss| / |reference loss|
  over the steps;
* ``grad_gap``: the first step's gradient as Adam got it (the port's
  ``exp_avg`` after one step over 1 − β1), by the worst leaf: the gap
  between the two norms of a leaf over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_gap``: the parameters' change over the steps, by the worst leaf
  as above, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move under Adam by rounding
  alone).

A step that leaves the state unchanged reads 1 on the last two.
"""

from __future__ import annotations

import math

import torch

NAMES = ("loss_gap", "grad_gap", "change_gap")
QUIET_LEAF = 1e-3   # of the median leaf's reference gradient norm


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _worst(prog: dict, ref: dict, leaves) -> float:
    ref_n, prog_n = _norms(ref), _norms(prog)
    med = sorted(ref_n.values())[len(ref_n) // 2]
    worst = 0.0
    for k in leaves:
        scale = max(ref_n[k], med)
        gap = abs(prog_n[k] - ref_n[k]) / scale if scale > 0 else (
            0.0 if prog_n[k] == 0 else math.inf)
        worst = max(worst, gap if math.isfinite(prog_n[k]) else math.inf)
    return worst


def gaps(program: dict, reference: dict, params0: dict) -> dict:
    """``program`` and ``reference``: ``losses`` (one a step),
    ``first_grad`` and ``params`` (after the steps) by leaf name."""
    lp, lr = program["losses"], reference["losses"]
    loss_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(lp, lr))
    leaves = list(reference["first_grad"])
    grad_gap = _worst(program["first_grad"], reference["first_grad"],
                      leaves)
    g_norms = _norms(reference["first_grad"])
    med = sorted(g_norms.values())[len(g_norms) // 2]
    moving = [k for k in leaves if g_norms[k] >= QUIET_LEAF * med]
    d_prog = {k: program["params"][k] - params0[k] for k in leaves}
    d_ref = {k: reference["params"][k] - params0[k] for k in leaves}
    change_gap = _worst(d_prog, d_ref, moving)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def judge(g: dict, limits: dict) -> bool:
    return all(math.isfinite(g[k]) and g[k] <= limits[k] for k in NAMES)


def lines(g: dict, limits: dict) -> list[str]:
    return [f"check {k} {g[k]!r} limit {limits[k]!r}" for k in NAMES]


def record(g: dict, limits: dict) -> dict:
    return {k: {"value": g[k], "limit": limits[k]} for k in NAMES}
