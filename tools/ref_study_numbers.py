#!/usr/bin/env python3
"""Print the JAX reference's numbers of ``examples/variation_study.py`` and
``examples/retention_study.py`` as JSON, unrounded, in the structure the
port's twins' ``run()`` returns (``examples/torch_variation_study.py``,
``torch_retention_study.py``).  ``chip_smoke.py`` phase 7 holds the twins
against them (``REF_VARIATION_STUDY``, ``REF_RETENTION_STUDY``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_study_numbers.py [--quick]

Runs the reference on the CPU (Pallas in interpret mode, its default
backend), each study as its example runs it; the retention study adds
the flip counts of the disturb fit's rungs, which the hold's bounds use.
"""
import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))

import numpy as np  # noqa: E402

import retention_study  # noqa: E402
import variation_study  # noqa: E402
from repro.campaign import CampaignGrid, run_campaign  # noqa: E402
from repro.core.params import (AFMTJ_PARAMS, CORNER_TT,  # noqa: E402
                               MTJ_PARAMS, VariationSpec)
from repro.imc import read_path  # noqa: E402
from repro.imc.evaluate import evaluate_system, summarize  # noqa: E402
from repro.imc.write_margin import DEVICE_DT  # noqa: E402

DISTURB_VOLTS = (0.02, 0.05, 0.10, 0.15)


def variation_numbers(quick: bool) -> dict:
    sigmas = (0.0, 0.2) if quick else (0.0, 0.1, 0.2)
    n_samples = 32 if quick else 64
    out = dict(sigmas=list(sigmas), n_samples=n_samples)
    for kind, params in (("afmtj", AFMTJ_PARAMS), ("mtj", MTJ_PARAMS)):
        pulses, dt = variation_study.LADDERS[kind]
        grid = CampaignGrid(voltages=(1.0,), pulse_widths=pulses,
                            temperatures=variation_study.TEMPS,
                            n_samples=n_samples, dt=dt, seed=0,
                            variation=VariationSpec(
                                corners=variation_study.corner_sweep(sigmas)))
        res = run_campaign(params, grid)
        wer = res.wer_surface()
        r = dict(launches=res.n_launches, wer_short=[], pulse=[])
        for ci in range(len(sigmas)):
            r["wer_short"].append(float(wer[ci, :, 0, 0].max()))
            try:
                r["pulse"].append(max(
                    res.pulse_for_wer(variation_study.WER_TARGET, t_index=ti,
                                      corner_index=ci)
                    for ti in range(len(variation_study.TEMPS))))
            except ValueError:
                r["pulse"].append(math.nan)
        out[kind] = r
    return out


def _tolist(a) -> list:
    return [float(x) for x in np.asarray(a).reshape(-1)]


def retention_numbers(quick: bool) -> dict:
    kw, dkw = {}, {}
    if quick:
        kw = dict(accel_factors=(0.05, 0.10), temperatures=(300.0,),
                  horizons=retention_study.log_pulses(0.15e-9, 1.2e-9,
                                                      per_decade=3),
                  n_samples=96, variation=VariationSpec(corners=(CORNER_TT,)))
        dkw = dict(n_samples=128, horizon=2.5e-9)
    res = read_path.retention_campaign("afmtj", **kw)
    shape = list(res.shape)
    ret = dict(
        corners=list(res.spec.corner_names), shape=shape,
        accel_factors=list(res.accel_factors),
        temperatures=list(res.temperatures), launches=res.n_launches,
        n_samples=res.grid.n_samples, n_steps=res.grid.n_steps,
        delta_eff=_tolist(res.delta_eff()), tau_acc=_tolist(res.tau_acc),
        n_flips=[int(x) for x in res.n_flips.reshape(-1)],
        slope=[res.arrhenius_fit(ci, ti)[0] for ci in range(shape[0])
               for ti in range(shape[1])],
        tau_op=_tolist(res.tau_op()), worst_tau_op=res.worst_tau_op())
    model = read_path.fit_disturb_model("afmtj", **dkw)
    tau0 = res.tau0(0, 0)
    # the fit's own campaign (cached by the call above): escapes per rung
    horizon = dkw.get("horizon", 4.0e-9)
    corner = dataclasses.replace(CORNER_TT, name=f"tt~{model.accel_factor:g}",
                                 b_aniso_factor=model.accel_factor)
    grid = CampaignGrid(voltages=model.voltages, pulse_widths=(horizon,),
                        temperatures=(AFMTJ_PARAMS.temperature,),
                        n_samples=dkw.get("n_samples", 256),
                        dt=DEVICE_DT["afmtj"], seed=11,
                        variation=VariationSpec(corners=(corner,)))
    ct = run_campaign(AFMTJ_PARAMS, grid, horizon="log").crossing_time
    flips = [read_path._censored_tau(ct[0, 0, vi], horizon)[1]
             for vi in range(len(model.voltages))]
    dist = dict(accel_factor=model.accel_factor, delta_acc=model.delta_acc,
                v_c=model.v_c, beta=model.beta, sse=model.sse,
                voltages=list(model.voltages), tau_meas=list(model.tau_meas),
                flips=flips, n_samples=grid.n_samples, tau0=tau0,
                delta_eff=[40.0 * model.suppression(v)
                           for v in DISTURB_VOLTS],
                p1=[model.p1(v, 0.5e-9, 40.0, tau0) for v in DISTURB_VOLTS])
    out = dict(quick=quick, retention=ret, disturb=dist, refresh=None)
    if not quick:
        pol = read_path.derive_refresh_policy("afmtj")
        base = evaluate_system("afmtj")
        wref = evaluate_system("afmtj", refresh=pol)
        f = dict(interval=pol.interval, limited_by=pol.limited_by,
                 tau_retention=pol.tau_retention, p1_read=pol.p1_read,
                 reads_max=pol.reads_max, ber_budget=pol.ber_budget,
                 reads_per_cell_s=pol.reads_per_cell_s,
                 summarize=list(summarize(base)),
                 summarize_refresh=list(summarize(wref)), share={})
        for name in ("bnn", "mat_add"):
            r = wref[name]
            f["share"][name] = [r.t_refresh / r.t_imc, r.e_refresh / r.e_imc]
        out["refresh"] = f
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    print(json.dumps({"variation": variation_numbers(args.quick),
                      "retention": retention_numbers(args.quick)}))


if __name__ == "__main__":
    main()
