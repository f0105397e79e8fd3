"""Host seconds of the configuration's graph transform (``nn/transforms.py``,
``gcn_norm`` for GCN), to a synchronise; nothing for a configuration
without one."""


def read(run):
    return run.spans.get("norm_build_s")
