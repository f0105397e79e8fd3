"""The share of the traced window in which no operation ran on the device:
1 - (the union of the device operations' intervals) / (the window)."""


def read(run):
    s = run.summary
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
