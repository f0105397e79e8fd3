"""Device ms an epoch of every operation launched inside the port's range
``isplib.att.bwd_e`` (``attribution/att_bwd_e/``): GAT's attention's
per-entry products, the softmax's and LeakyReLU's backward and the
scores' gradients (``ops/attention.py``, ``kernels/gat_attention.py``).
Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("att_bwd_e", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["att_bwd_e"] / s.epochs
