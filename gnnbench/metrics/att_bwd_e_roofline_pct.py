"""The attention's ``bwd_e`` role's share of its bound: the least time its
passes of one epoch could take (``counts/<config>.py`` ``role_bound_s``,
from the graph and the equations, never a plan) over the device time
inside ``isplib.att.bwd_e`` an epoch.  Nothing for a configuration without
the attention or a trace without the range."""


def read(run):
    s = run.summary
    bound = getattr(run.counts, "role_bound_s", None)
    if (s is None or run.peak is None or bound is None
            or s.group_s.get("att_bwd_e", 0.0) <= 0.0):
        return None
    return 100.0 * bound(run.config, run.graph, "bwd_e", run.peak) / (
        s.group_s["att_bwd_e"] / s.epochs)
