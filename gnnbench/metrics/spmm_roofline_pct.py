"""The epoch's aggregations' share of their bound: the sum over the
aggregations of ``counts/<config>.py`` of the least time the card could
take (``bound.py``, from the graph and the equations, never a plan) over
the device time the aggregation took (``spmm_ms``)."""

from gnnbench.bound import aggregation_bound_s


def read(run):
    s = run.summary
    if s is None or run.peak is None or s.group_s.get("spmm", 0.0) <= 0.0:
        return None
    bound = sum(aggregation_bound_s(a, run.peak)
                for a in run.counts.aggregations(run.config, run.graph))
    return 100.0 * bound / (s.group_s["spmm"] / s.epochs)
