"""Host seconds of the graph build (``sparse/graph.py`` ``from_edge_index``,
the native ``_build_arrays``, and the upload), to a synchronise."""


def read(run):
    return run.spans.get("graph_build_s")
