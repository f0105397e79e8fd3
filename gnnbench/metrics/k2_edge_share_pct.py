"""The share of A's edges that v5 puts in K2's dense blocks
(``sparse/tiling_v5.py``'s dense/residual split, duplicates counted as the
CSR holds them): the port's ``plan.v5`` stage of direction ``A``, 100 ·
``dense_edges`` / (``dense_edges`` + ``residual_edges``).  Nothing when the
run built no v5 plan (a CPU graph is never tiled)."""

from gnnbench import stages


def read(run):
    s = stages.last("plan.v5", direction="A")
    if s is None:
        return None
    dense, residual = s["attrs"]["dense_edges"], s["attrs"]["residual_edges"]
    if dense + residual == 0:
        return None
    return 100.0 * dense / (dense + residual)
