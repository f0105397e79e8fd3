"""Host seconds of the plans (``sparse/tiling.py`` ``auto_tile``: v5 of A and
Aᵀ and the max/min plan), to a synchronise."""


def read(run):
    return run.spans.get("plan_build_s")
