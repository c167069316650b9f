"""Write-path study on the PyTorch/CUDA port: measured write-verify
statistics and the accuracy-vs-write-energy surface (DESIGN.md §7), the
twin of ``examples/write_path_study.py`` for ``src/repro_torch``.

Part 1 sweeps the write operating point at a fixed per-attempt pulse (the
1.0 V device-nominal x 1.5 margin): lower drive voltage eats the STT
overdrive, so the retry scheduler pays more attempts and the residual
bit-error rate climbs.  Every write-verify round is one launch of the LLG
kernel on the card.

Part 2 is the co-design trade: each residual-WER target buys a verify
attempt budget, the scheduler measures what that budget costs in write
energy and latency, and the surviving bit errors go into the analog read
path (``AnalogConfig.write_ber``) to score a decode-step GEMV through the
bit-line MAC kernel.

    python examples/torch_write_path_study.py                # GPU
    python examples/torch_write_path_study.py --device cpu --quick
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.imc.mapping import write_energy_accuracy_surface  # noqa: E402
from repro_torch.imc.write_path import WritePolicy, write_surface  # noqa: E402

VOLTAGES = (0.8, 1.0, 1.2)
TEMPS = {"afmtj": (300.0, 375.0), "mtj": (300.0,)}
ARCH = "gemma2-2b"
WER_TARGETS = (3e-1, 1e-1, 1e-2, 1e-4)
CAPS = dict(cap_k=256, cap_n=128, batch=4)


def sizes(quick: bool) -> tuple:
    """(cells per surface point, cells per write-accuracy point)."""
    return (64, 128) if quick else (128, 256)


def run(device=None, quick=False) -> dict:
    """The study's numbers: per kind the write surface's pulse and (T, V)
    maps, and the write/accuracy points per WER target."""
    n_surface, n_accuracy = sizes(quick)
    out = dict(n_surface=n_surface, n_accuracy=n_accuracy, surface={})
    for kind in ("afmtj", "mtj"):
        surf = write_surface(kind, voltages=VOLTAGES,
                             temperatures=TEMPS[kind], n_cells=n_surface,
                             policy=WritePolicy(v_write=1.0, max_attempts=6),
                             device=device)
        out["surface"][kind] = dict(
            pulse=surf.pulses[0], temperatures=list(surf.temperatures),
            voltages=list(surf.voltages),
            attempts=surf.attempts_mean[..., 0].tolist(),
            residual_ber=surf.residual_ber[..., 0].tolist(),
            latency=surf.latency_mean[..., 0].tolist(),
            energy=surf.energy_mean[..., 0].tolist())
    # pulse_margin < 1: the pulse undershoots the mean switching time, so
    # the WER-target axis moves the attempt budget
    pts = write_energy_accuracy_surface(
        ARCHS[ARCH], kind="afmtj", wer_targets=WER_TARGETS,
        policy=WritePolicy(v_write=1.0, pulse_margin=0.9),
        n_cells=n_accuracy, device=device, **CAPS)
    out["accuracy"] = [dict(target=t, budget=pt.attempts_budget,
                            write_ber=pt.write_ber,
                            e_write_bit=pt.e_write_bit,
                            t_write_mean=pt.t_write_mean,
                            nmse=pt.report.nmse, cosine=pt.report.cosine)
                       for t, pt in sorted(pts.items(), reverse=True)]
    return out


def report(res: dict) -> list:
    """The lines ``examples/write_path_study.py`` prints, from ``run``'s
    numbers."""
    lines = ["=== Write-verify retries vs operating point (fixed per-attempt "
             f"pulse, {res['n_surface']} cells) ===", ""]
    for kind, s in res["surface"].items():
        lines += [f"--- {kind}  (pulse {s['pulse'] * 1e12:.0f} ps)",
                  f"  {'T[K]':>5} {'V':>4} {'attempts':>8} {'resid_ber':>9} "
                  f"{'lat_mean[ps]':>12} {'e_mean[fJ]':>10}"]
        for ti, temp in enumerate(s["temperatures"]):
            for vi, v in enumerate(s["voltages"]):
                lines.append(
                    f"  {temp:5.0f} {v:4.1f} {s['attempts'][ti][vi]:8.2f} "
                    f"{s['residual_ber'][ti][vi]:9.4f} "
                    f"{s['latency'][ti][vi] * 1e12:12.0f} "
                    f"{s['energy'][ti][vi] * 1e15:10.1f}")
        lines.append("")
    lines += [f"=== Accuracy vs write energy ({ARCH} decode GEMV, afmtj, "
              "deliberately tight pulse) ===", "",
              f"  {'wer_target':>10} {'budget':>6} {'write_ber':>9} "
              f"{'e[fJ/bit]':>9} {'t_mean[ps]':>10} {'nmse':>10} "
              f"{'cosine':>8}"]
    for pt in res["accuracy"]:
        lines.append(f"  {pt['target']:10.0e} {pt['budget']:6d} "
                     f"{pt['write_ber']:9.1e} {pt['e_write_bit'] * 1e15:9.1f} "
                     f"{pt['t_write_mean'] * 1e12:10.0f} {pt['nmse']:10.2e} "
                     f"{pt['cosine']:8.5f}")
    lines += ["", "reading the surface: each decade of residual-WER target "
              "costs ~one more\nverify attempt of write energy/latency; the "
              "nmse floor at tight targets is\nthe read path's own "
              "non-ideality (ADC + IR drop), the blow-up at loose\ntargets is "
              "stuck-at-floor cells the MVM has to eat."]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--quick", action="store_true",
                    help="half the cells per point (fast sanity run)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device, args.quick))))


if __name__ == "__main__":
    main()
