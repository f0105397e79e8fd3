"""Device ms an epoch of every operation launched inside the aggregation's
host ranges (``attribution/spmm/``), forward and backward: kernels and torch
operations alike."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("spmm", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["spmm"] / s.epochs
