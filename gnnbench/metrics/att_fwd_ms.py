"""Device ms an epoch of every operation launched inside the port's range
``isplib.att.fwd`` (``attribution/att_fwd/``): GAT's attention forward,
the row statistics and the weighted sum (``ops/attention.py``,
``kernels/gat_attention.py``), a padded copy of a ragged head too.
Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("att_fwd", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["att_fwd"] / s.epochs
