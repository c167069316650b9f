"""Fault study on the PyTorch/CUDA port: graceful degradation under hard
faults, with and without repair (DESIGN.md §13), the twin of
``examples/fault_study.py`` for ``src/repro_torch``.

Stuck-at / dead-line defect planes (``FaultSpec``) at rising cell-fault
rates, through three layers of the stack:

1. array yield and cell-area overhead per repair policy (the Poisson
   repair-capacity model),
2. model-level accuracy degradation (KL and greedy token match of a
   whole forward routed through the fake-analog MVM kernel) vs rate x
   repair policy, with the knee where remapping stops saving accuracy,
3. serving SLO attainment on a fixed Poisson trace re-priced under each
   (policy, rate).

4. a crash-resumable campaign: a multi-launch campaign dies after its
   first launch is checkpointed, and the rerun resumes from the slice
   checkpoint, bit-identical to an uninterrupted run.

    python examples/torch_fault_study.py                # GPU
    python examples/torch_fault_study.py --device cpu --quick
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.campaign.engine import run_campaign  # noqa: E402
from repro_torch.campaign.grid import CampaignGrid, bucket_cells  # noqa: E402
from repro_torch.core.params import AFMTJ_PARAMS  # noqa: E402
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
    their knees, the serving SLO curve and the crash-resume demo."""
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
    out["resume"] = resume_demo(device)
    return out


class _Abort(Exception):
    pass


def resume_demo(device=None) -> dict:
    """Section 4: a two-launch campaign dies after launch 0 is
    checkpointed; the rerun resumes from the checkpoint.  Returns the
    launches, how many were resumed, and whether the crossing tensor equals
    an uninterrupted run's bit for bit."""
    grid = CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12,),
                        temperatures=(300.0, 350.0), n_samples=16,
                        dt=0.1e-12, seed=0)
    per = bucket_cells(grid.cells)
    crashed = []

    def die_early(i, n):
        crashed.append((i, n))
        if i == 0:
            raise _Abort

    fresh = run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                         max_cells_per_launch=per, device=device)
    with tempfile.TemporaryDirectory() as td:
        try:
            run_campaign(AFMTJ_PARAMS, grid, cache_dir=td,
                         max_cells_per_launch=per,
                         on_slice_complete=die_early, device=device)
        except _Abort:
            pass
        res = run_campaign(AFMTJ_PARAMS, grid, cache_dir=td,
                           max_cells_per_launch=per, device=device)
    return dict(crashed=crashed, n_launches=res.n_launches,
                n_resumed=res.n_resumed,
                same=bool(np.array_equal(res.crossing_time,
                                         fresh.crossing_time)))


def report(res: dict) -> list:
    """The lines of ``examples/fault_study.py``, from ``run``'s
    numbers."""
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
    lines += ["", "== crash-resumable campaign =="]
    rs = res["resume"]
    lines += [f"  launch {i + 1}/{n} checkpointed ... simulated crash"
              for i, n in rs["crashed"]]
    lines.append(f"  resumed: {rs['n_resumed']}/{rs['n_launches']} launches "
                 f"from checkpoints, crossing tensor bit-identical="
                 f"{rs['same']}")
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
