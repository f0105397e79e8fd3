"""Device ms an epoch of every operation launched inside the port's range
``isplib.K3`` (``attribution/k3/``): K3, ``kernels/spmm_minmax_v4.py``, its
pre-pass, gather and decode.  Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("k3", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["k3"] / s.epochs
