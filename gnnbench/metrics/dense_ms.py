"""Device ms an epoch of every operation not attributed to the aggregation
(dense layers, loss, Adam and whatever else the step launches)."""


def read(run):
    s = run.summary
    if s is None:
        return None
    return 1e3 * (s.device_s - s.group_s.get("spmm", 0.0)) / s.epochs
