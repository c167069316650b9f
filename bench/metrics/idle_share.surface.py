"""The device's idle share of the traced window: 1 - the union of the
device operations' intervals over the window's length, in %."""


def read(run):
    tr = run.traced
    if not tr.device or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
