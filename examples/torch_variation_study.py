"""Process-variation study on the PyTorch/CUDA port: WER and the margined
write pulse vs device-to-device sigma, AFMTJ vs MTJ (DESIGN.md §9), the
twin of ``examples/variation_study.py`` for ``src/repro_torch``.

Each D2D sigma rides as its own process corner of one ``VariationSpec``
centred on the slow (ss) corner, so the whole (sigma x T x pulse ladder)
scenario space of a device kind is one fused campaign: one launch of the
LLG kernel's variation instance on the card.  The margin is taken at the
worst (T, corner) cell.

    python examples/torch_variation_study.py                # GPU
    python examples/torch_variation_study.py --device cpu --quick
"""
import argparse
import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.campaign import CampaignGrid, run_campaign  # noqa: E402
from repro_torch.core.params import (AFMTJ_PARAMS, CORNER_SS,  # noqa: E402
                                     MTJ_PARAMS, VariationSpec)

TEMPS = (300.0, 340.0)
WER_TARGET = 5e-2
# per-kind pulse ladders bracketing the thermal tail, and the step
LADDERS = {
    "afmtj": (tuple(x * 1e-12 for x in
                    (200, 225, 250, 275, 300, 350, 400, 500)), 0.1e-12),
    "mtj": (tuple(x * 1e-12 for x in
                  (1800, 2000, 2200, 2500, 2800, 3200, 3600)), 0.2e-12),
}
KINDS = (("afmtj", AFMTJ_PARAMS), ("mtj", MTJ_PARAMS))


def sizes(quick: bool) -> tuple:
    """(sigma levels, samples) of the full study or of ``--quick``."""
    return ((0.0, 0.2), 32) if quick else ((0.0, 0.1, 0.2), 64)


def corner_sweep(sigmas):
    """One corner per D2D sigma level, all centred on the slow corner."""
    return tuple(
        dataclasses.replace(CORNER_SS, name=f"ss/d2d={s:g}", sigma_alpha=s,
                            sigma_b_aniso=s, sigma_volume=s, sigma_r=s)
        for s in sigmas)


def study(params, kind, sigmas, n_samples, device=None,
          use_cache=True) -> dict:
    """One kind's fused campaign: per sigma the worst-T WER at the shortest
    rung and the margined pulse [s] (NaN when no rung meets the target)."""
    pulses, dt = LADDERS[kind]
    grid = CampaignGrid(voltages=(1.0,), pulse_widths=pulses,
                        temperatures=TEMPS, n_samples=n_samples, dt=dt,
                        seed=0,
                        variation=VariationSpec(corners=corner_sweep(sigmas)))
    res = run_campaign(params, grid, use_cache=use_cache, device=device)
    wer = res.wer_surface()                       # (n_sigma, n_T, 1, n_P)
    out = dict(launches=res.n_launches, elapsed_s=res.elapsed_s,
               from_cache=res.from_cache, wer_short=[], pulse=[])
    for ci in range(len(sigmas)):
        out["wer_short"].append(float(wer[ci, :, 0, 0].max()))
        try:
            pulse = max(res.pulse_for_wer(WER_TARGET, t_index=ti,
                                          corner_index=ci)
                        for ti in range(len(TEMPS)))
        except ValueError:
            pulse = math.nan
        out["pulse"].append(float(pulse))
    return out


def run(device=None, quick=False, use_cache=True) -> dict:
    """The study's numbers: per kind the launches, the worst-T WER at the
    shortest rung and the margined pulse per sigma level."""
    sigmas, n_samples = sizes(quick)
    out = dict(sigmas=list(sigmas), n_samples=n_samples)
    for kind, params in KINDS:
        out[kind] = study(params, kind, sigmas, n_samples, device, use_cache)
    return out


def report(res: dict) -> list:
    """The lines ``examples/variation_study.py`` prints, from ``run``'s
    numbers."""
    sigmas, n = res["sigmas"], res["n_samples"]
    lines = ["WER-margined write pulse vs device-to-device sigma at the slow "
             f"process corner (worst T in {TEMPS} K, WER <= {WER_TARGET:g})"]
    for kind, _ in KINDS:
        pulses = LADDERS[kind][0]
        r = res[kind]
        lines += ["",
                  f"{kind}: {len(sigmas)} sigma levels x {len(TEMPS)} T x "
                  f"{n} samples, {len(pulses)}-rung ladder -> "
                  f"{r['launches']} launch(es), {r['elapsed_s']:.1f}s"
                  f"{' (cache)' if r['from_cache'] else ''}",
                  f"  {'D2D sigma':>10} "
                  f"{'WER@' + format(pulses[0] * 1e12, '.0f') + 'ps':>12} "
                  f"{'margined pulse':>15}"]
        for s, w, p in zip(sigmas, r["wer_short"], r["pulse"]):
            ptxt = f"{p * 1e12:9.0f} ps" if p == p else "  > ladder"
            lines.append(f"  {s:>10g} {w:>12.3f} {ptxt:>15}")
    lines += ["", "margin cost of D2D spread (vs the same device at "
              "sigma=0):"]
    for i, s in enumerate(sigmas[1:], start=1):
        row = []
        for kind, _ in KINDS:
            p, p0 = res[kind]["pulse"][i], res[kind]["pulse"][0]
            g = p / p0
            row.append(f"{kind} +{(p - p0) * 1e12:.0f} ps ({g:.2f}x)"
                       if g == g else f"{kind} n/a")
        lines.append(f"  sigma={s:g}: " + "   ".join(row))
    lines += ["", "Both devices widen their pulse with D2D spread, but the "
              "AFMTJ's ps-scale exchange-enhanced reversal pays tens of "
              "picoseconds of variation margin where the MTJ pays hundreds "
              "— the nominal ~8x write-latency advantage survives at the "
              "worst (T, corner) cell, which is the headroom the companion "
              "paper's variation-resilient drivers exploit (DESIGN.md §9)."]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer samples / sigma levels (fast sanity run)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device, args.quick))))


if __name__ == "__main__":
    main()
