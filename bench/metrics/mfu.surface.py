"""Model FLOPs of the window's points (``flops.forward_flops``: the
linears with experts at their top k, and the attention's whole square)
over the device's busy time in the traced window (the union of its
operations: the profiler slows the host and so the window, not the work
on the device), as a share of the dense bf16 peak of 989 TFLOP/s (the
card's power limit is printed beside it)."""
from benchlib import flops


def read(run):
    n = len(run.records)
    if not n or run.traced.busy_s <= 0.0:
        return None
    f = n * flops.forward_flops(run.config, run.traffic["batch"],
                                run.traffic["seq_len"])
    return 100.0 * f / run.traced.busy_s / flops.H100_BF16_DENSE_FLOPS
