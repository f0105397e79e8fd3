"""Host seconds of the whole-graph copies between host and card: the
port's ``graph.upload`` (``sparse/graph.py``), ``norm.readback``
(``nn/transforms.py``) and ``plan.readback`` (``sparse/tiling.py``) stages
of the run summed."""

from gnnbench import stages


def read(run):
    return stages.total_s(("graph.upload", "norm.readback", "plan.readback"))
