"""Model FLOPs of the window's points on the hybrid Mamba-2 / attention
MoE model (``hybrid_flops.forward_flops``: the products with experts at
their top k, the attention's whole square, the state-space dual form's
intra-chunk and state products) over the device's busy time in the traced
window, as a share of the dense bf16 peak of 989 TFLOP/s."""
from benchlib import flops, hybrid_flops


def read(run):
    n = len(run.records)
    if not n or run.traced.busy_s <= 0.0:
        return None
    f = n * hybrid_flops.forward_flops(run.config, run.traffic["batch"],
                                       run.traffic["seq_len"])
    return 100.0 * f / run.traced.busy_s / flops.H100_BF16_DENSE_FLOPS
