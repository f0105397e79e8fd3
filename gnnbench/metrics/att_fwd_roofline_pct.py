"""The attention's ``fwd`` role's share of its bound: the least time its
passes of one epoch could take (``counts/<config>.py`` ``role_bound_s``,
from the graph and the equations, never a plan) over the device time
inside ``isplib.att.fwd`` an epoch.  Nothing for a configuration without
the attention or a trace without the range."""


def read(run):
    s = run.summary
    bound = getattr(run.counts, "role_bound_s", None)
    if (s is None or run.peak is None or bound is None
            or s.group_s.get("att_fwd", 0.0) <= 0.0):
        return None
    return 100.0 * bound(run.config, run.graph, "fwd", run.peak) / (
        s.group_s["att_fwd"] / s.epochs)
