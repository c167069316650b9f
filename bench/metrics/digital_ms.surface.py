"""Device milliseconds per point in every operation that is not an analog
kernel (the forward's attention, norms, MoE, the operand preamble's
tensor work and the scoring), over the traced window."""
from benchlib.kernels import is_analog


def read(run):
    n = len(run.records)
    if not n or not run.traced.device:
        return None
    t = sum(e.seconds for e in run.traced.device if not is_analog(e.name))
    return 1e3 * t / n
