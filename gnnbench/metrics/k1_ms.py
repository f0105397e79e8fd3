"""Device ms an epoch of every operation launched inside the port's range
``isplib.K1`` (``attribution/k1/``): K1, ``kernels/spmm_stream.py``, over
the residual edges.  Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("k1", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["k1"] / s.epochs
