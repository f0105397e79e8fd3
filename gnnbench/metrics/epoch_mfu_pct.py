"""The whole epoch's share of the card's dense bf16 tensor-core peak: the
configuration's model operations (``counts/<config>.py``) over the traced
epoch time (the traced window over its epochs)."""


def read(run):
    s = run.summary
    if s is None or run.peak is None:
        return None
    epoch_s = s.window_s / s.epochs
    flops = run.counts.model_flops(run.config, run.graph)
    return 100.0 * flops / (epoch_s * run.peak["bf16_tensor_flops_per_s"])
