"""Host seconds of the graph builds' stable sorts (``sparse/graph.py``
``_build_arrays``, ``native.sort_csr``): the port's ``graph.sort`` stages
of the run summed, two a graph build (GCN's ``gcn_norm`` builds two more
graphs)."""

from gnnbench import stages


def read(run):
    return stages.total_s(("graph.sort",))
