"""The analog products' share of their roofline on the hybrid Mamba-2 /
attention MoE model, as ``analog_roofline.surface`` defines it: the least
time for every analog MVM of the window's points (the attention
projections, the shared expert and the unembed,
``hybrid_flops.analog_work``) over the analog kernels' device time.  The
FP32-SIMT share is printed beside it."""
from benchlib import flops, hybrid_flops
from benchlib.kernels import is_analog


def read(run):
    n = len(run.records)
    t = sum(e.seconds for e in run.traced.device if is_analog(e.name))
    if not n or t <= 0.0:
        return None
    m = run.traffic["batch"] * run.traffic["seq_len"]
    ops, n_bytes = hybrid_flops.analog_work(run.config, m)
    fp32 = n * flops.least_seconds(ops, n_bytes, flops.H100_FP32_SIMT_FLOPS)
    run.info["analog_fp32_simt_share_pct"] = 100.0 * fp32 / t
    run.info["analog_device_ms_per_point"] = 1e3 * t / n
    return 100.0 * n * flops.least_seconds(
        ops, n_bytes, flops.H100_BF16_DENSE_FLOPS) / t
