"""Array-scale thermal Monte-Carlo write simulation on the PyTorch/CUDA
port, the twin of ``examples/array_mc_sim.py`` for ``src/repro_torch``.

Every cell of an AFMTJ subarray (per-cell drive from IR drop and 300 K
thermal noise in the kernel) integrates the dual-sublattice LLG dynamics
in one launch of the campaign kernel (``csrc/llg_rk4.cu``, through
``campaign.run_ensemble``).  Reports the write-latency distribution, the
worst cell, the array's WER(pulse) curve, and the controller pulse that
the WER-margined campaign gives at the worst IR-drop cell.

The initial tilts are drawn with a ``torch.Generator`` seeded 0; the
reference draws them with ``jax.random``, so the two print different
samples of the same statistics.  ``run(theta=, phi=)`` or ``run(m0=)``
takes them from the caller instead.

    python examples/torch_array_mc_sim.py                # GPU
    python examples/torch_array_mc_sim.py --device cpu   # plain PyTorch
"""
import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.campaign.engine import run_ensemble  # noqa: E402
from repro_torch.core import llg  # noqa: E402
from repro_torch.core.device import thermal_theta0  # noqa: E402
from repro_torch.core.params import AFMTJ_PARAMS  # noqa: E402
from repro_torch.imc.write_margin import wer_margined_pulse  # noqa: E402

ROWS, COLS = 64, 64
DT = 0.1e-12
N_STEPS = 4100          # horizon > the longest WER pulse below (400 ps), so
                        # never-switched cells can't alias a 400 ps success
PULSES = (250e-12, 300e-12, 350e-12, 400e-12)
WER_TARGET = 1e-2


def tilt_draws(n: int, seed: int = 0):
    """|N(0, 1)| tilt normals and U(0, 2 pi) azimuths of ``n`` cells, from
    a CPU ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    zs = torch.randn(n, generator=gen, dtype=torch.float32).abs()
    ph = torch.rand(n, generator=gen, dtype=torch.float32) * (2 * math.pi)
    return zs, ph


def run(device=None, rows=ROWS, cols=COLS, n_steps=N_STEPS, m0=None,
        theta=None, phi=None, use_cache=True) -> dict:
    """The example's numbers.  ``m0`` ((rows cols, 2, 3)) or ``theta`` /
    ``phi`` ((rows cols,) each) replace the drawn initial states.  Returns
    the crossing steps, the switched share, the ensemble's wall time, the
    latency statistics of switched cells [s], the array WER at ``PULSES``,
    the worst cell's drive and its WER-margined pulse [s]."""
    dev = resolve_device(device)
    n = rows * cols
    if m0 is None:
        if theta is None:
            zs, phi = tilt_draws(n)
            theta = zs * float(thermal_theta0(AFMTJ_PARAMS)) + 0.02
        theta = torch.as_tensor(np.asarray(theta, np.float32), device=dev)
        phi = torch.as_tensor(np.asarray(phi, np.float32), device=dev)
        m0 = llg.initial_state(AFMTJ_PARAMS, theta, phi)
    m0 = torch.as_tensor(m0, dtype=torch.float32, device=dev)
    row = torch.arange(n, device=dev) // cols
    v = 1.0 - 0.15 * (row.to(torch.float32) / rows)   # 15% IR drop

    # the first call loads the kernel library; the second is timed
    run_ensemble(AFMTJ_PARAMS, m0, v, DT, n_steps, seed=0, device=dev)
    res = run_ensemble(AFMTJ_PARAMS, m0, v, DT, n_steps, seed=0, device=dev)
    t_sw = res.crossing_time
    ok = t_sw[res.switched]
    v_worst = float(v.min())
    pulse = wer_margined_pulse("afmtj", v_write=round(v_worst, 2),
                               wer_target=WER_TARGET, use_cache=use_cache,
                               device=dev)
    return dict(
        rows=rows, cols=cols, n_steps=n_steps,
        crossing_steps=res.crossing_steps,
        switched=float(res.switched.mean()), elapsed_s=res.elapsed_s,
        mean=float(ok.mean()), p50=float(np.percentile(ok, 50)),
        p99=float(np.percentile(ok, 99)), max=float(ok.max()),
        wer=[float((t_sw > pl).mean()) for pl in PULSES],
        v_worst=v_worst, pulse=pulse)


def report(res: dict) -> list:
    """The lines ``examples/array_mc_sim.py`` prints, from ``run``'s
    numbers."""
    n = res["rows"] * res["cols"]
    lines = [
        f"array {res['rows']}x{res['cols']} @300K: "
        f"{res['switched'] * 100:.1f}% switched within "
        f"{res['n_steps'] * DT * 1e12:.0f} ps  "
        f"({res['elapsed_s'] * 1e6 / n:.0f} us/cell, one kernel launch)",
        f"t_switch: mean {res['mean'] * 1e12:.0f} ps, p50 "
        f"{res['p50'] * 1e12:.0f}, p99 {res['p99'] * 1e12:.0f}, max "
        f"{res['max'] * 1e12:.0f} ps",
        "", "pulse_ps  array_WER"]
    lines += [f"{pl * 1e12:8.0f}  {w:.4f}" for pl, w in zip(PULSES,
                                                           res["wer"])]
    lines += ["", f"=> controller pulse for WER<={WER_TARGET:g} at the worst "
              f"IR-drop cell ({res['v_worst']:.2f} V): "
              f"{res['pulse'] * 1e12:.0f} ps (campaign-engine margin)"]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device))))


if __name__ == "__main__":
    main()
