"""Host seconds of ``gcn_norm``'s own work (``nn/transforms.py``: the
self-loop mask, ``np.add.at`` over the edges, the new values): the port's
``norm.gcn`` stage less its child stages (its two read backs and two graph
builds).  Nothing for a configuration without the transform."""

from gnnbench import stages


def read(run):
    return stages.self_s("norm.gcn")
