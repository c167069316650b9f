"""Model FLOPs of the window's training steps (``flops.train_flops``:
6 N T + 12 L h hd S T, N the parameters in products) over the device's
busy time in the traced window (the union of its operations: the
profiler slows the host and so the window, not the work on the device),
as a share of the dense bf16 peak of 989 TFLOP/s (the card's power limit
is printed beside it)."""
from benchlib import flops


def read(run):
    n = len(run.records)
    if not n or run.traced.busy_s <= 0.0:
        return None
    t = run.config["train_4k"]
    f = n * flops.train_flops(run.config, flops.matmul_params(run.config, True),
                              t["global_batch"], t["seq_len"])
    return 100.0 * f / run.traced.busy_s / flops.H100_BF16_DENSE_FLOPS
