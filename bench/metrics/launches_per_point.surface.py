"""Kernel launches on the device per point (copies and sets not counted),
over the traced window: a count."""
from benchlib.kernels import is_launch


def read(run):
    n = len(run.records)
    k = sum(1 for e in run.traced.device if is_launch(e.name))
    if not n or not k:
        return None
    return k / n
