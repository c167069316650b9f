"""Fault study on the PyTorch/CUDA port: graceful degradation under hard
faults, with and without repair (DESIGN.md §13), the twin of sections 1-3
of ``examples/fault_study.py`` for ``src/repro_torch``.

Stuck-at / dead-line defect planes (``FaultSpec``) at rising cell-fault
rates, through three layers of the stack:

1. array yield and cell-area overhead per repair policy (the Poisson
   repair-capacity model),
2. model-level accuracy degradation (KL and greedy token match of a
   whole forward routed through the fake-analog MVM kernel) vs rate x
   repair policy, with the knee where remapping stops saving accuracy,
3. serving SLO attainment on a fixed Poisson trace re-priced under each
   (policy, rate).

The reference's section 4 (crash-resume from slice checkpoints) waits for
the port's slice checkpoints (ROADMAP A12).

    python examples/torch_fault_study.py                # GPU
    python examples/torch_fault_study.py --device cpu --quick
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.imc.faults import (REPAIR_SPARE,  # noqa: E402
                                    REPAIR_SPARE_ECC, FaultSpec)
from repro_torch.imc.mapping import fault_cost_factors  # noqa: E402
from repro_torch.imc.model_analog import (degradation_knee,  # noqa: E402
                                          model_degradation_curves)
from repro_torch.launch.simulate import fault_slo_curve  # noqa: E402

RATES = (0.0, 1e-3, 3e-3, 1e-2, 3e-2)
SLO_RATES = (0.0, 1e-4, 3e-4, 1e-3)
YIELD_RATE = 1e-3
POLICIES = (("none", None), ("spare", REPAIR_SPARE),
            ("spare+ecc", REPAIR_SPARE_ECC))


def sizes(quick: bool) -> tuple:
    """((batch, seq_len), degradation rates, serving requests)."""
    if quick:
        return (1, 32), (0.0, 3e-3, 1e-2, 3e-2), 600
    return (2, 64), RATES, 4000


def run(device=None, quick=False, arch="qwen2-0.5b") -> dict:
    """The study's numbers: the yield table, the degradation curves with
    their knees, and the serving SLO curve."""
    (batch, seq_len), rates, n_requests = sizes(quick)
    spec = FaultSpec.at_rate(YIELD_RATE, seed=0)
    out = dict(arch=arch, batch=batch, seq_len=seq_len, rates=list(rates),
               n_requests=n_requests,
               yields=[(name,) + fault_cost_factors(spec, pol)
                       for name, pol in POLICIES])
    reports = model_degradation_curves(arch, rates=rates,
                                       policies=(None, REPAIR_SPARE),
                                       batch=batch, seq_len=seq_len,
                                       device=device)
    curves = {}
    for r in reports:
        curves.setdefault(r.repair, []).append((r.kl, r.token_match))
    bar = 0.8 * curves["none"][0][1]
    out.update(curves=curves, bar=bar,
               knees=degradation_knee(reports, min_token_match=bar))
    out["slo"] = [(p.repair, p.fault_rate, p.array_yield, p.slo_attainment,
                   p.tpot_p99_s, p.tokens_per_joule)
                  for p in fault_slo_curve("afmtj", rates=SLO_RATES,
                                           policies=(None, REPAIR_SPARE),
                                           n_requests=n_requests,
                                           device=device)]
    return out


def report(res: dict) -> list:
    """The lines of sections 1-3 of ``examples/fault_study.py``, from
    ``run``'s numbers."""
    lines = ["", f"== repair-capacity yield at cell-fault rate "
             f"{YIELD_RATE:g} ==",
             f"{'policy':10s} {'yield':>12s} {'cell_ovh':>9s} "
             f"{'t_stretch':>10s}"]
    for name, y, ovh, stretch in res["yields"]:
        lines.append(f"{name:10s} {y:12.3e} {ovh:9.3f} {stretch:10.3g}")
    lines += ["one uncorrected stuck pair condemns a row: without spares the "
              "Poisson capacity model collapses the yield",
              "", f"== model degradation: {res['arch']} smoke forward, "
              f"batch {res['batch']} x seq {res['seq_len']} ==",
              f"{'rate':>8s}" + "".join(f" {p + '.kl':>10s} {p + '.match':>9s}"
                                        for p in res["curves"])]
    for i, rate in enumerate(res["rates"]):
        row = f"{rate:8g}"
        for rs in res["curves"].values():
            row += f" {rs[i][0]:10.4f} {rs[i][1]:9.3f}"
        lines.append(row)
    lines += [f"knee (largest rate with token match >= {res['bar']:.2f}): "
              + ", ".join(f"{p}={k:g}" for p, k in sorted(res["knees"].items())),
              "", f"== serving SLO attainment vs fault rate "
              f"({res['n_requests']} Poisson requests, fixed trace + healthy "
              f"SLO) ==",
              f"{'policy':8s} {'rate':>8s} {'yield':>10s} {'SLO':>6s} "
              f"{'tpot_p99':>10s} {'tok/J':>10s}"]
    for repair, rate, y, att, tpot, tpj in res["slo"]:
        lines.append(f"{repair:8s} {rate:8g} {y:10.3e} {att:6.3f} "
                     f"{tpot:10.3e} {tpj:10.3e}")
    lines += ["", "== crash-resumable campaign ==",
              "  not run on the port: slice checkpoints and resume wait for "
              "ROADMAP A12"]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller forward + fewer requests (seconds)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device, args.quick, args.arch))))


if __name__ == "__main__":
    main()
