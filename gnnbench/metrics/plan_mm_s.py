"""Host seconds of the max/min work lists (``sparse/tiling_v4mm.py``
``build_minmax_plan`` of A, with K3's schedule, and of Aᵀ): the port's
``plan.mm`` stages of the run summed.  Nothing when the run built no plan
(a CPU graph is never tiled)."""

from gnnbench import stages


def read(run):
    return stages.total_s(("plan.mm",))
