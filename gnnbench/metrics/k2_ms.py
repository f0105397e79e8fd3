"""Device ms an epoch of every operation launched inside the port's range
``isplib.K2`` (``attribution/k2/``): K2, ``kernels/spmm_bsr.py``, over the
dense blocks, its pre-pass included.  Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("k2", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["k2"] / s.epochs
