"""Device ms an epoch of every operation launched inside the port's range
``isplib.att.bwd_x`` (``attribution/att_bwd_x/``): GAT's attention's
transposed weighted sum, x's gradient (``ops/attention.py``,
``kernels/gat_attention.py``), a padded copy of a ragged head too.
Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("att_bwd_x", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["att_bwd_x"] / s.epochs
