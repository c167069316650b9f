"""The analog products' share of their roofline in the traced window: the
least time the card could take for every analog MVM of the window's
points (2 M K N operations plus one conductance rebuild per weight
element at the dense bf16 peak, or x and w read once and the output
written once at the HBM rate, whichever is longer) over the device time of
the analog kernels.  The FP32-SIMT share is printed beside it."""
from benchlib import flops
from benchlib.kernels import is_analog


def read(run):
    n = len(run.records)
    t = sum(e.seconds for e in run.traced.device if is_analog(e.name))
    if not n or t <= 0.0:
        return None
    m = run.traffic["batch"] * run.traffic["seq_len"]
    ops, n_bytes = flops.analog_work(run.config, m)
    fp32 = n * flops.least_seconds(ops, n_bytes, flops.H100_FP32_SIMT_FLOPS)
    run.info["analog_fp32_simt_share_pct"] = 100.0 * fp32 / t
    run.info["analog_device_ms_per_point"] = 1e3 * t / n
    return 100.0 * n * flops.least_seconds(
        ops, n_bytes, flops.H100_BF16_DENSE_FLOPS) / t
