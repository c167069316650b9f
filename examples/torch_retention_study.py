"""Retention study on the PyTorch/CUDA port: accelerated-barrier retention,
read disturb and the refresh policy they imply (DESIGN.md §10), the twin of
``examples/retention_study.py`` for ``src/repro_torch``.

Composed process corners scale ``b_aniso_factor`` down until Delta_eff sits
in a measurable 2-6 window; escape times are measured on a log-spaced
horizon ladder (one fused launch of the LLG kernel's variation instance
for the whole (corner x accel x horizon x sample) grid), an Arrhenius fit
cross-checks the barrier law, and the slope-pinned extrapolation projects
tau to the operating barrier.  The same acceleration fits the read-disturb
suppression, and both set the scrub interval charged into Fig. 4.

    python examples/torch_retention_study.py                # GPU
    python examples/torch_retention_study.py --device cpu --quick
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.campaign.grid import log_pulses  # noqa: E402
from repro_torch.core.params import CORNER_TT, VariationSpec  # noqa: E402
from repro_torch.imc.evaluate import evaluate_system, summarize  # noqa: E402
from repro_torch.imc.read_path import (derive_refresh_policy,  # noqa: E402
                                       fit_disturb_model, retention_campaign)

SECONDS_PER_YEAR = 3.156e7
DISTURB_VOLTS = (0.02, 0.05, 0.10, 0.15)


def _tolist(a) -> list:
    return [float(x) for x in a.reshape(-1)]


def retention_numbers(quick: bool, device, use_cache: bool):
    kw = {}
    if quick:
        kw = dict(accel_factors=(0.05, 0.10), temperatures=(300.0,),
                  horizons=log_pulses(0.15e-9, 1.2e-9, per_decade=3),
                  n_samples=96,
                  variation=VariationSpec(corners=(CORNER_TT,)))
    res = retention_campaign("afmtj", use_cache=use_cache, device=device,
                             **kw)
    shape = list(res.shape)
    return res, dict(
        corners=list(res.spec.corner_names), shape=shape,
        accel_factors=list(res.accel_factors),
        temperatures=list(res.temperatures), launches=res.n_launches,
        n_samples=res.grid.n_samples, n_steps=res.grid.n_steps,
        delta_eff=_tolist(res.delta_eff()), tau_acc=_tolist(res.tau_acc),
        n_flips=[int(x) for x in res.n_flips.reshape(-1)],
        slope=[res.arrhenius_fit(ci, ti)[0] for ci in range(shape[0])
               for ti in range(shape[1])],
        tau_op=_tolist(res.tau_op()), worst_tau_op=res.worst_tau_op())


def disturb_numbers(quick: bool, res, device, use_cache: bool) -> dict:
    kw = dict(n_samples=128, horizon=2.5e-9) if quick else {}
    model = fit_disturb_model("afmtj", use_cache=use_cache, device=device,
                              **kw)
    tau0 = res.tau0(0, 0)
    return dict(accel_factor=model.accel_factor, delta_acc=model.delta_acc,
                v_c=model.v_c, beta=model.beta, sse=model.sse,
                voltages=list(model.voltages),
                tau_meas=list(model.tau_meas), tau0=tau0,
                delta_eff=[40.0 * model.suppression(v)
                           for v in DISTURB_VOLTS],
                p1=[model.p1(v, 0.5e-9, 40.0, tau0) for v in DISTURB_VOLTS])


def refresh_numbers(device, use_cache: bool) -> dict:
    pol = derive_refresh_policy("afmtj", use_cache=use_cache, device=device)
    base = evaluate_system("afmtj", device=device)
    wref = evaluate_system("afmtj", refresh=pol, device=device)
    out = dict(interval=pol.interval, limited_by=pol.limited_by,
               tau_retention=pol.tau_retention, p1_read=pol.p1_read,
               reads_max=pol.reads_max, ber_budget=pol.ber_budget,
               reads_per_cell_s=pol.reads_per_cell_s,
               summarize=list(summarize(base)),
               summarize_refresh=list(summarize(wref)), share={})
    for name in ("bnn", "mat_add"):
        r = wref[name]
        out["share"][name] = [r.t_refresh / r.t_imc, r.e_refresh / r.e_imc]
    return out


def run(device=None, quick=False, use_cache=True) -> dict:
    """The study's numbers: the retention campaign's reductions, the
    disturb fit and its p1 table, and (full size only) the refresh policy
    and Fig. 4 with and without the scrub."""
    res, ret = retention_numbers(quick, device, use_cache)
    out = dict(quick=quick, retention=ret,
               disturb=disturb_numbers(quick, res, device, use_cache))
    out["refresh"] = None if quick else refresh_numbers(device, use_cache)
    return out


def report(res: dict) -> list:
    """The lines ``examples/retention_study.py`` prints, from ``run``'s
    numbers."""
    r = res["retention"]
    n_c, n_t, n_f = r["shape"]
    lines = [f"accelerated retention: {n_c} corners x {n_f} accel factors x "
             f"{n_t} T -> {r['launches']} launch(es)",
             f"  {'corner':>8} {'T[K]':>5} {'Delta_eff':>22} "
             f"{'tau_acc [ns]':>26} {'slope':>6} {'tau_op [s]':>11}"]
    for ci, name in enumerate(r["corners"]):
        for ti, temp in enumerate(r["temperatures"]):
            k = (ci * n_t + ti) * n_f
            taus = "/".join(f"{t * 1e9:.1f}" if t == t else "-"
                            for t in r["tau_acc"][k:k + n_f])
            deffs = "/".join(f"{d:.1f}" for d in r["delta_eff"][k:k + n_f])
            lines.append(f"  {name:>8} {temp:5.0f} {deffs:>22} {taus:>26} "
                         f"{r['slope'][ci * n_t + ti]:6.2f} "
                         f"{r['tau_op'][ci * n_t + ti]:11.2e}")
    w = r["worst_tau_op"]
    lines.append(f"  worst-corner tau_op {w:.2e} s "
                 f"(~{w / SECONDS_PER_YEAR:.2f} years); Arrhenius slope ~1 "
                 "confirms exponential barrier scaling (Kramers prefactor "
                 "folds into tau0)")
    d = res["disturb"]
    lines += ["", f"read-disturb suppression fit (accel "
              f"x{d['accel_factor']:g}, Delta_acc {d['delta_acc']:.1f}):",
              f"  V_c = {d['v_c']:.3f} V, beta = {d['beta']:.2f} "
              "(switching threshold ~0.19 V)",
              f"  {'V_read':>7} {'Delta_eff':>9} {'p1/read @0.5ns':>14}"]
    for v, de, p1 in zip(DISTURB_VOLTS, d["delta_eff"], d["p1"]):
        lines.append(f"  {v:7.2f} {de:9.1f} {p1:14.2e}")
    lines.append("  the nominal 0.1 V read bias sits too close to V_c: "
                 "disturb forces either a derated read bias or an "
                 "aggressive scrub schedule")
    f = res["refresh"]
    if f is None:
        lines += ["", "(refresh-policy derivation needs the full-size "
                  "campaigns; rerun without --quick)"]
        return lines
    lines += ["", f"refresh policy @ {f['ber_budget']:g} BER budget, "
              f"{f['reads_per_cell_s']:g} reads/s/cell:",
              f"  retention-limited tau {f['tau_retention']:.2e} s, "
              f"disturb p1 {f['p1_read']:.2e} -> {f['reads_max']:.1f} reads "
              "max",
              f"  scrub every {f['interval'] * 1e6:.2f} us "
              f"({f['limited_by']}-limited)",
              f"  Fig. 4 avg speedup {f['summarize'][0]:.1f}x -> "
              f"{f['summarize_refresh'][0]:.1f}x, energy saving "
              f"{f['summarize'][1]:.1f}x -> {f['summarize_refresh'][1]:.1f}x "
              "with scrub charged"]
    for name, (t_share, e_share) in f["share"].items():
        lines.append(f"    {name:8s}: refresh {100 * t_share:.1f}% of "
                     f"t_imc, {100 * e_share:.1f}% of e_imc")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--quick", action="store_true",
                    help="small accelerated grids (fast sanity run)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device, args.quick))))


if __name__ == "__main__":
    main()
