#!/usr/bin/env python3
"""Print the JAX reference's numbers of ``examples/variation_study.py``,
``examples/retention_study.py``, ``examples/array_mc_sim.py`` and
``examples/analog_accuracy.py`` as JSON, unrounded, in the structure the
port's twins' ``run()`` returns (``examples/torch_variation_study.py``,
``torch_retention_study.py``, ``torch_array_mc_sim.py``,
``torch_analog_accuracy.py``).  ``chip_smoke.py`` holds the twins against
them (phase 7: ``REF_VARIATION_STUDY``, ``REF_RETENTION_STUDY``; phase 11:
``REF_ARRAY_MC``, ``REF_ANALOG_ACCURACY``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_study_numbers.py \
        [--quick] [--only variation retention array_mc analog_accuracy]

Runs the reference on the CPU (Pallas in interpret mode, its default
backend), each study as its example runs it; the retention study adds
the flip counts of the disturb fit's rungs, and the array study the
standard deviation of the switched cells' latency and the latency
quantiles' sample counts, which the holds' bounds use.
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

import analog_accuracy  # noqa: E402
import array_mc_sim  # noqa: E402
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


def array_mc_numbers() -> dict:
    """``examples/array_mc_sim.py``'s numbers (its draws and its calls)."""
    import jax
    import jax.numpy as jnp

    from repro.campaign import run_ensemble
    from repro.core import llg
    from repro.core.device import thermal_theta0
    from repro.imc.write_margin import wer_margined_pulse

    ex = array_mc_sim
    n = ex.ROWS * ex.COLS
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    th0 = float(thermal_theta0(AFMTJ_PARAMS))
    theta = jnp.abs(jax.random.normal(k1, (n,))) * th0 + 0.02
    phi = jax.random.uniform(k2, (n,), maxval=2 * jnp.pi)
    m0 = jax.vmap(lambda t, f: llg.initial_state(AFMTJ_PARAMS, t, f))(theta,
                                                                      phi)
    v = 1.0 - 0.15 * ((jnp.arange(n) // ex.COLS) / ex.ROWS)
    res = run_ensemble(AFMTJ_PARAMS, m0, v, ex.DT, ex.N_STEPS, seed=0)
    t_sw = np.asarray(res.crossing_time)
    ok = t_sw[res.switched]
    v_worst = float(jnp.min(v))
    pulse = wer_margined_pulse("afmtj", v_write=round(v_worst, 2),
                               wer_target=1e-2)
    return dict(rows=ex.ROWS, cols=ex.COLS, n_steps=ex.N_STEPS,
                switched=float(res.switched.mean()), n_switched=int(ok.size),
                mean=float(ok.mean()), std=float(ok.std(ddof=1)),
                p50=float(np.percentile(ok, 50)),
                p99=float(np.percentile(ok, 99)), max=float(ok.max()),
                wer=[float((t_sw > pl).mean())
                     for pl in (250e-12, 300e-12, 350e-12, 400e-12)],
                v_worst=v_worst, pulse=pulse)


def analog_accuracy_numbers() -> dict:
    """``examples/analog_accuracy.py``'s numbers, keyed as the twin's."""
    from repro.configs.registry import ARCHS
    from repro.imc.mapping import (accuracy_surface,
                                   decode_projection_accuracy,
                                   decode_projection_shapes)

    ex = analog_accuracy
    out = {}
    for name in ex.SWEEP_ARCHS:
        cfg = ARCHS[name]
        k, n = decode_projection_shapes(cfg, ex.CAPS["cap_k"],
                                        ex.CAPS["cap_n"])
        surf = accuracy_surface(cfg, kind="afmtj", adc_bits=ex.ADC_BITS,
                                tmrs=ex.TMRS, variation=ex.VARIATION,
                                **ex.CAPS)
        bnn = decode_projection_accuracy(cfg, kind="afmtj", mode="bnn",
                                         **ex.CAPS)
        out[name] = dict(
            shape=[ex.CAPS["batch"], k, n],
            surface={f"{bits}/{tmr}": [r.mse, r.nmse, r.cosine]
                     for (bits, tmr), r in sorted(surf.items())},
            bnn=[bnn.mse, bnn.nmse, bnn.cosine])
    return out


STUDIES = ("variation", "retention", "array_mc", "analog_accuracy")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", nargs="+", choices=STUDIES, default=STUDIES)
    args = ap.parse_args()
    make = {"variation": lambda: variation_numbers(args.quick),
            "retention": lambda: retention_numbers(args.quick),
            "array_mc": array_mc_numbers,
            "analog_accuracy": analog_accuracy_numbers}
    print(json.dumps({name: make[name]() for name in args.only}))


if __name__ == "__main__":
    main()
