"""Device ms an epoch of every operation launched inside the port's range
``isplib.route`` (``attribution/route/``): the max/min backward's routing
of the gradient to the winning edges (``ops/spmm.py``), for ``grad_x`` and
``grad_v``.  Nothing when the trace holds none."""


def read(run):
    s = run.summary
    if s is None or s.group_s.get("route", 0.0) <= 0.0:
        return None
    return 1e3 * s.group_s["route"] / s.epochs
