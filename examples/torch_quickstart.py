"""Quickstart on the PyTorch/CUDA port: AFMTJ vs MTJ write operations
(paper Fig. 3), the twin of ``examples/quickstart.py`` for
``src/repro_torch``.

Every write runs through the single-junction write kernel
(``csrc/llg_write.cu``): one launch per voltage sweep.

    python examples/torch_quickstart.py                 # GPU
    python examples/torch_quickstart.py --device cpu    # plain PyTorch
    python examples/torch_quickstart.py --device cpu --afmtj-steps 3000 \\
        --mtj-steps 14000                               # short horizons
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.device import simulate_write, write_sweep  # noqa: E402
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS  # noqa: E402
from repro_torch.core.tmr import tmr_ratio  # noqa: E402

VOLTAGES = (0.5, 0.8, 1.0, 1.2)
AFMTJ_STEPS, AFMTJ_DT = 16000, 0.05e-12
MTJ_STEPS, MTJ_DT = 60000, 0.1e-12


def run(device=None, afmtj_steps=AFMTJ_STEPS, mtj_steps=MTJ_STEPS) -> dict:
    """The quickstart's numbers: per kind the sweep's latency [s], energy
    [J] and switched flags at ``VOLTAGES``, and the single 1 V AFMTJ
    write."""
    out = {}
    for kind, p, n, dt in (("afmtj", AFMTJ_PARAMS, afmtj_steps, AFMTJ_DT),
                           ("mtj", MTJ_PARAMS, mtj_steps, MTJ_DT)):
        r = write_sweep(p, VOLTAGES, n_steps=n, dt=dt, device=device)
        out[kind] = dict(latency=[float(x) for x in r.write_latency],
                         energy=[float(x) for x in r.energy],
                         switched=[bool(x) for x in r.switched])
    r = simulate_write(AFMTJ_PARAMS, 1.0, n_steps=afmtj_steps, dt=AFMTJ_DT,
                       device=device)
    out["single"] = dict(latency=float(r.write_latency),
                         energy=float(r.energy), switched=bool(r.switched))
    return out


def report(res: dict) -> list:
    """The lines ``examples/quickstart.py`` prints, from ``run``'s numbers."""
    a, m, s = res["afmtj"], res["mtj"], res["single"]
    lines = [
        "=== AFMTJ vs MTJ write characteristics (dual-sublattice LLG) ===",
        "",
        f"AFMTJ: B_exchange={AFMTJ_PARAMS.b_exchange:.2f} T, "
        f"TMR={tmr_ratio(AFMTJ_PARAMS)*100:.0f}%, "
        f"R_P={AFMTJ_PARAMS.r_parallel:.0f} Ohm",
        f"MTJ:   single FM layer, TMR={tmr_ratio(MTJ_PARAMS)*100:.0f}%",
        "",
        f"{'V':>5} | {'AFMTJ lat':>10} {'AFMTJ E':>9} | "
        f"{'MTJ lat':>10} {'MTJ E':>9} | {'speedup':>7}"]
    for i, v in enumerate(VOLTAGES):
        lines.append(
            f"{v:5.1f} | {a['latency'][i]*1e12:8.0f}ps "
            f"{a['energy'][i]*1e15:7.1f}fJ | "
            f"{m['latency'][i]*1e12:8.0f}ps "
            f"{m['energy'][i]*1e15:7.1f}fJ | "
            f"{m['latency'][i] / a['latency'][i]:6.1f}x")
    lines += ["",
              f"@1.0V: {s['latency']*1e12:.0f} ps / {s['energy']*1e15:.1f} fJ"
              f"  (paper: 164 ps / 55.7 fJ)",
              f"Neel vector reversed: {s['switched']}"]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--afmtj-steps", type=int, default=AFMTJ_STEPS)
    ap.add_argument("--mtj-steps", type=int, default=MTJ_STEPS)
    args = ap.parse_args()
    res = run(args.device, args.afmtj_steps, args.mtj_steps)
    print("\n".join(report(res)))


if __name__ == "__main__":
    main()
