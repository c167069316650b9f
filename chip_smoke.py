#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. Print the card (``nvidia-smi`` name and power limit), PyTorch and CUDA
   versions; build ``src/repro_torch/kernels/csrc/llg_rk4.cu`` with nvcc;
   TF32 off.
1. The LLG kernel against its plain PyTorch version on the card, on the
   same inputs: deterministic and thermal, chunk 0 and 64, ragged step
   budgets, two Brown sigmas, single-sublattice (MTJ) and variation rows.
   Bound: rows 0-5 within atol 2e-5 and row 7 (first crossing) equal —
   the reference's own kernel-vs-oracle bound.
2. The paper's chain at full width through the entry points a user calls:
   the Fig. 3 device writes (``simulate_write``), ``wer_margined_pulse``
   (1 V, WER <= 1e-2, 128 samples) and ``evaluate_system`` for both device
   kinds, closed-form and with measured p99 write-verify timings (the
   real L1/L2/MM hierarchy: 256x256, 256x256, 512x512 subarrays; 16 rows of
   write-verify per level).  Deterministic anchors are held within 1% of
   the JAX reference's values; AFMTJ must beat MTJ on every workload.
3. One reliability campaign at a study's size: 3 temperatures x 2 voltages
   x 100,000 samples = 600,000 lanes x 2,501 steps, timed.
4. Every launch shape of the main path, timed on the card and held against
   the plain version on the same inputs: the campaign of phase 3, the
   write-verify first rounds of ``evaluate_system(write_percentile=99.0)``
   (4,096 and 8,192 lanes) and the 128-sample WER ladder, for both device
   kinds.

The kernel's launch counter is set to 0 before phase 2 and read after
phase 3's campaign; the second-to-last line is the per-kernel JSON record
and the last line ``{"ok": true, "device": {...}}``.  Campaign caching is
off (``use_cache=False``, and a fresh empty cache directory for the calls
that cache internally) so no result can skip the kernel.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# JAX reference values (src/repro, CPU): circuit.subarray._characterize_write
# (latency, energy) at 1 V and imc.evaluate.summarize(evaluate_system(kind))
REF_WRITE = {"afmtj": (1.2546315375505657e-10, 4.0518586749693775e-14),
             "mtj": (1.3394828579649243e-09, 3.60453610319042e-13)}
REF_SUMMARIZE = {"afmtj": (14.939246898721372, 17.41633381712113),
                 "mtj": (6.647316258326578, 3.1090744983784835)}
ANCHOR_RTOL = 0.01
KERNEL_ATOL = 2e-5

# Operations per lane-step of the thermal kernel, by sublattice count:
# (float32 operations counted from csrc/llg_rk4.cu, its header note gives
# the breakdown; special-function-unit operations = MUFU.RCP + MUFU.RSQ per
# step in the sm_90a SASS, counted by tools/sass_census.py: one per IEEE
# division and one per sqrtf; logf/sinf/cosf issue none).  Each
# transcendental counts as one float32 operation, so the bound is a floor.
OPS_PER_LANE_STEP = {2: (606, 36), 1: (317, 20)}
H100_FP32_OPS_S = 67e12        # NVIDIA data sheet, H100 SXM, 700 W
H100_SFU_OPS_S = 132 * 16 * 1.98e9   # 16 SFU lanes / SM / clock, boost clock


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn):
    """(result, milliseconds) of ``fn()`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(out_k, out_p, n_steps: int, tag: str) -> float:
    import torch

    d = (out_k[:6] - out_p[:6]).abs().max().item()
    mism = int((out_k[7] != out_p[7]).sum().item())
    same67 = bool(torch.equal(out_k[6], out_p[6]))
    log(f"  {tag}: max|d rows0-5| = {d:.3e}, row-7 mismatches = {mism}, "
        f"crossed = {int((out_p[7] < n_steps).sum().item())}")
    if not (d <= KERNEL_ATOL and mism == 0 and same67):
        raise AssertionError(f"{tag}: kernel disagrees with its plain version "
                             f"(max|d| {d}, row-7 mismatches {mism})")
    return d


def executed_lane_steps(out, budget, n_kernel: int, chunk: int,
                        block: int) -> int:
    """Lane-steps the kernel integrated on these inputs: a lane stops at its
    budget, a block of ``block`` lanes at the first chunk boundary where
    every lane has crossed or used its budget."""
    import numpy as np

    row7 = out[7].double().cpu().numpy()
    bud = budget.double().cpu().numpy()
    n_chunks = -(-n_kernel // chunk)
    crossed = np.where(row7 < n_kernel, row7, np.inf)
    done_at = np.ceil(np.minimum(crossed, bud) / chunk)
    done_at = np.minimum(done_at, n_chunks)
    block_exit = done_at.reshape(-1, block).max(axis=1) * chunk
    lane_exit = np.repeat(block_exit, block)
    return int(np.minimum(bud, np.minimum(lane_exit, n_kernel)).sum())


def bound_ms(lane_steps: int, nsub: int) -> tuple:
    """(least milliseconds for ``lane_steps`` of the ``nsub`` kernel, and
    which unit bounds it: 'fp32' or 'sfu')."""
    fp32, sfu = OPS_PER_LANE_STEP[nsub]
    t_fp = fp32 * lane_steps / H100_FP32_OPS_S
    t_sfu = sfu * lane_steps / H100_SFU_OPS_S
    return 1e3 * max(t_fp, t_sfu), "fp32" if t_fp >= t_sfu else "sfu"


def phase1(torch, dev):
    from repro_torch.core.montecarlo import thermal_sigma
    from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
    from repro_torch.kernels import noise, ref
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    log("phase 1: kernel vs plain version on the card")
    gen = torch.Generator(device="cpu").manual_seed(1234)
    cells = 4096

    def states(p, vlo, vhi):
        th = torch.rand(cells, generator=gen) * 0.35 + 0.05
        ph = torch.rand(cells, generator=gen) * 6.2831855
        m1 = torch.stack([th.sin() * ph.cos(), th.sin() * ph.sin(), th.cos()])
        s = torch.zeros(8, cells)
        s[0:3] = m1
        if p.n_sublattices == 2:
            s[3:6] = -m1
        s[6] = torch.linspace(vlo, vhi, cells)
        return s.to(dev)

    def thermal_kw(p, dt, n, chunk, variation=False):
        lane = torch.arange(cells)
        sigma = torch.where(lane % 2 == 0, thermal_sigma(p, dt),
                            thermal_sigma(p, dt) * math.sqrt(400.0 / 300.0))
        budget = torch.full((cells,), float(n))
        budget[lane % 5 == 0] = float(n // 3)
        budget[lane % 97 == 0] = 0.0
        kw = dict(thermal_sigma=sigma.float().to(dev),
                  seeds=noise.cell_seeds(77, cells, dev),
                  step_budget=budget.to(dev), chunk=chunk)
        if variation:
            kw["lane_params"] = torch.stack([
                p.alpha * (0.8 + 0.4 * torch.rand(cells, generator=gen)),
                p.b_aniso * (0.9 + 0.2 * torch.rand(cells, generator=gen)),
                0.85 + 0.3 * torch.rand(cells, generator=gen)]).float().to(dev)
        return kw

    cases = [
        ("afmtj deterministic 4096x400", AFMTJ_PARAMS, 0.1e-12, 400,
         (0.3, 1.2), None),
        ("mtj deterministic 4096x400", MTJ_PARAMS, 0.2e-12, 400,
         (2.0, 5.0), None),
        ("afmtj thermal chunk=0 4096x1500", AFMTJ_PARAMS, 0.1e-12, 1500,
         (0.6, 2.0), dict(chunk=0)),
        ("afmtj thermal chunk=64 4096x1500", AFMTJ_PARAMS, 0.1e-12, 1500,
         (0.6, 2.0), dict(chunk=64)),
        ("mtj (NSUB=1) thermal chunk=64 4096x3000", MTJ_PARAMS, 0.2e-12, 3000,
         (2.0, 5.0), dict(chunk=64)),
        ("afmtj variation rows chunk=64 4096x1500", AFMTJ_PARAMS, 0.1e-12,
         1500, (0.6, 2.0), dict(chunk=64, variation=True)),
    ]
    for tag, p, dt, n, (vlo, vhi), th in cases:
        st = states(p, vlo, vhi)
        kw = {} if th is None else thermal_kw(p, dt, n, **th)
        out_k, ms_k = cuda_ms(lambda: llg_rk4_kernel(st, p, dt, n, **kw))
        out_p, ms_p = cuda_ms(lambda: ref.ref_llg_rk4(st, p, dt, n, **kw))
        compare(out_k, out_p, n, f"{tag} (kernel {ms_k:.2f} ms, plain "
                f"{ms_p:.0f} ms)")


def phase2(torch):
    from repro_torch.circuit import subarray
    from repro_torch.core.device import simulate_write
    from repro_torch.imc import evaluate
    from repro_torch.imc.write_margin import wer_margined_pulse
    from repro_torch.imc.write_path import (measured_write_timings,
                                            nominal_pulse)
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    log("phase 2: device -> write path -> Fig. 4 at full width")
    for f in (wer_margined_pulse, measured_write_timings, nominal_pulse,
              subarray._characterize_write):
        f.cache_clear()
    assert simulate_write is subarray.simulate_write
    launches = {}
    for kind in ("afmtj", "mtj"):
        # the Fig. 3 write as the subarray model runs it (t_rc = 0); the
        # closed-form and measured evaluations below reuse this solve
        t0 = time.perf_counter()
        lat, en = subarray._characterize_write(kind, 1.0, None)
        dt_s = time.perf_counter() - t0
        log(f"  simulate_write {kind} 1 V: latency {lat * 1e12:.2f} ps, "
            f"energy {en * 1e15:.3f} fJ (with the 40 ps line charge: "
            f"{(lat + 40e-12) * 1e12:.2f} ps), {dt_s:.1f} s")
        ref_lat, ref_en = REF_WRITE[kind]
        assert abs(lat / ref_lat - 1) < ANCHOR_RTOL, (kind, lat, ref_lat)
        assert abs(en / ref_en - 1) < ANCHOR_RTOL, (kind, en, ref_en)

    results = {}
    for kind in ("afmtj", "mtj"):
        before = llg_rk4_kernel.launches
        t0 = time.perf_counter()
        pulse = wer_margined_pulse(kind, 1.0, 1e-2, use_cache=False)
        log(f"  wer_margined_pulse {kind} 1 V WER<=1e-2: {pulse * 1e12:.0f} ps "
            f"({time.perf_counter() - t0:.2f} s, "
            f"{llg_rk4_kernel.launches - before} launches)")
        for mode, kw in (("closed-form", {}),
                         ("p99 write-verify", dict(write_percentile=99.0))):
            before = llg_rk4_kernel.launches
            t0 = time.perf_counter()
            res = evaluate.evaluate_system(kind, **kw)
            n_l = llg_rk4_kernel.launches - before
            sp, es = evaluate.summarize(res)
            log(f"  evaluate_system {kind} {mode}: summarize speedup "
                f"{sp:.3f}x, energy saving {es:.3f}x "
                f"({time.perf_counter() - t0:.2f} s, {n_l} launches)")
            for name, r in res.items():
                log(f"    {name:14s} speedup {r.speedup:8.3f}x  energy saving "
                    f"{r.energy_saving:8.3f}x  write op {r.t_write_op * 1e12:8.1f}"
                    f" ps  attempts {r.write_attempts:.3f}")
            results[(kind, mode)] = res
            if mode == "closed-form":
                ref_sp, ref_es = REF_SUMMARIZE[kind]
                assert abs(sp / ref_sp - 1) < ANCHOR_RTOL, (kind, sp, ref_sp)
                assert abs(es / ref_es - 1) < ANCHOR_RTOL, (kind, es, ref_es)
            else:
                launches[kind] = n_l
                assert n_l > 0, f"{kind}: write-verify never launched the kernel"
    for mode in ("closed-form", "p99 write-verify"):
        a, m = results[("afmtj", mode)], results[("mtj", mode)]
        for name in a:
            assert a[name].speedup > m[name].speedup, (mode, name)
            assert a[name].energy_saving > m[name].energy_saving, (mode, name)
    log(f"  launches per evaluate_system(write_percentile=99.0): {launches}")
    return launches


def phase3(torch, dev):
    import numpy as np

    from repro_torch.campaign import CampaignGrid, run_campaign
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    log("phase 3: 600,000-lane campaign")
    grid = CampaignGrid(voltages=(0.6, 1.2), pulse_widths=(120e-12, 250e-12),
                        temperatures=(300.0, 350.0, 400.0), n_samples=100_000,
                        dt=0.1e-12, seed=0)
    t0 = time.perf_counter()
    res = run_campaign(AFMTJ_PARAMS, grid, use_cache=False)
    wall = time.perf_counter() - t0
    lanes = len(grid.temperatures) * grid.cells
    wer = res.wer_surface()
    log(f"  run_campaign: {lanes} lanes x {grid.n_steps} steps in {wall:.2f} s "
        f"({lanes * grid.n_steps / wall:.4g} lane-steps/s, backend "
        f"{res.backend})")
    log(f"  wer_surface (T, V, pulse):\n{np.array2string(wer, precision=5)}")
    log(f"  latency p50/p99 [ps]:\n"
        f"{np.array2string(res.latency_percentiles() * 1e12, precision=2)}")
    assert wer.shape == (3, 2, 2) and np.isfinite(wer).all()
    assert ((wer >= 0) & (wer <= 1)).all()
    assert (np.diff(wer, axis=2) <= 0).all(), "WER must not grow with pulse"
    assert (wer[:, 1] <= wer[:, 0]).all(), "WER must not grow with voltage"
    return llg_rk4_kernel.launches, grid, wall


def hold_at_shape(dev, kind: str, grid, what: str) -> dict:
    """Pack ``grid`` as ``run_campaign`` does, time the kernel's launch on
    it (after one warm launch) and the plain version's, and hold the two
    against each other."""
    from repro_torch.campaign import pack_campaign
    from repro_torch.campaign.engine import EARLY_EXIT_CHUNK, _quantize_steps
    from repro_torch.imc.write_margin import params_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
    from repro_torch.kernels.ref import CELL_TILE

    p = params_for(kind)
    state, seeds, sigma, budget, _ = pack_campaign(grid, p, dev)
    n_kernel = _quantize_steps(grid.n_steps)
    kw = dict(thermal_sigma=sigma, seeds=seeds, step_budget=budget,
              chunk=EARLY_EXIT_CHUNK)
    run = lambda: llg_rk4_kernel(state, p, grid.dt, n_kernel, **kw)
    run()
    out_k, ms_k = cuda_ms(run)
    out_p, ms_p = cuda_ms(lambda: ref.ref_llg_rk4(
        state, p, grid.dt, n_kernel, **kw))
    lanes = state.shape[1]
    err = compare(out_k, out_p, n_kernel, f"{kind} {what}: {lanes} lanes x "
                  f"{grid.n_steps} steps (horizon {n_kernel}; kernel "
                  f"{ms_k:.3f} ms, plain {ms_p:.0f} ms)")
    steps = executed_lane_steps(out_k, budget, n_kernel, EARLY_EXIT_CHUNK,
                                CELL_TILE)
    b_ms, unit = bound_ms(steps, p.n_sublattices)
    log(f"    executed lane-steps {steps} -> bound {b_ms:.4f} ms ({unit}); "
        f"kernel at {100 * b_ms / ms_k:.1f}% of it")
    return dict(kind=kind, what=what, lanes=lanes, steps=grid.n_steps,
                horizon=n_kernel, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_unit=unit, lane_steps=steps, max_abs_err=err)


def main_path_shapes(dev, campaign_grid) -> list:
    """Every launch shape of the main path: the phase-3 campaign, the first
    write-verify rounds of the L1/L2 (16 x 256) and MM (16 x 512) levels at
    each kind's nominal x 1.5 pulse, and the 128-sample WER ladder."""
    from repro_torch.campaign import CampaignGrid
    from repro_torch.imc.write_margin import _LADDERS, DEVICE_DT, params_for
    from repro_torch.imc.write_path import WritePolicy

    log("phase 4: the main path's launch shapes, kernel vs plain version")
    out = [hold_at_shape(dev, "afmtj", campaign_grid, "campaign")]
    for kind in ("afmtj", "mtj"):
        policy = WritePolicy()
        temps = (params_for(kind).temperature,)
        for n_cells in (4096, 8192):
            grid = CampaignGrid(voltages=(policy.v_write,),
                                pulse_widths=(policy.resolved_pulse(kind),),
                                temperatures=temps, n_samples=n_cells,
                                dt=policy.resolved_dt(kind),
                                seed=policy.seed * 1009)
            out.append(hold_at_shape(dev, kind, grid, "write-verify round"))
        grid = CampaignGrid(voltages=(1.0,), pulse_widths=_LADDERS[kind],
                            temperatures=temps, n_samples=128,
                            dt=DEVICE_DT[kind], seed=0)
        out.append(hold_at_shape(dev, kind, grid, "WER ladder"))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"phase 0: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = build.build("llg_rk4")
    log(f"  nvcc build of llg_rk4.cu: {t_build:.1f} s" if t_build else
        "  llg_rk4.cu already built")
    for line in build.build_log("llg_rk4").splitlines():
        if "registers" in line or "spill" in line:
            log("   ", line.strip())
    cache = ROOT / "build" / "smoke-campaign-cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_CAMPAIGN_CACHE"] = str(cache)
    dev = torch.device("cuda")

    phase1(torch, dev)
    llg_rk4_kernel.launches = 0
    launches_ev = phase2(torch)
    main_launches, grid, wall = phase3(torch, dev)
    if main_launches <= 0:
        raise AssertionError("the main path never launched the LLG kernel")
    shapes = main_path_shapes(dev, grid)
    shutil.rmtree(cache, ignore_errors=True)
    m = shapes[0]

    record = {"kernels": [{
        "name": "llg_rk4",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/llg_rk4.cu",
        "replaces": "src/repro/kernels/llg_rk4.py:318",
        "launches": main_launches,
        "max_abs_err": max(x["max_abs_err"] for x in shapes),
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "shape": "600000 lanes (786432 padded) x 2501 steps, chunk 64",
        "lane_steps": m["lane_steps"],
        "campaign_wall_s": wall,
        "launches_per_evaluate_system_p99": launches_ev,
        "main_path_shapes": shapes,
    }]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
