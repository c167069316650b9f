"""Stochastic write path: write-verify programming through LLG transients.

Port of ``repro.imc.write_path``.  A write-verify scheduler programs cells
through thermal LLG transients: one fixed-width pulse per cell (a
single-point campaign through ``campaign.run_campaign``), success read off
the first-crossing row, and only failed cells re-pulsed with fresh thermal
samples, up to ``max_attempts`` rounds.  Out come measured per-cell latency
/ energy, retry counts and the residual bit-error rate.

With ``WritePolicy.variation`` (one process corner, DESIGN.md §9) every
cell is a sampled device: its D2D rows ride the LLG kernel's variation
plane through ``campaign.run_ensemble`` and persist across its retries,
while each round draws a fresh tilt (``grid.tilt_draws``, as a nominal
round of the same seed draws it) scaled by the cell's own theta0 and a
fresh thermal stream; energy uses the cell's own conductances.
``write_verify_corners`` runs one schedule per corner of a spec.
``program_bits`` programs a bit matrix (one ``write_verify`` over the
flipped cells, scattered back into a residual error map) and
``write_surface`` measures the retry / latency / energy maps over the
write operating point (temperature x voltage x pulse).

Conventions (as the reference): attempts are independent thermal trials
(fresh tilt and noise stream per round); per-attempt energy charges G_P up
to the crossing and G_AP for the pulse remainder (failed attempts: G_P for
the whole pulse), plus the driver line-charge overhead ``t_rc`` at G_P;
verify cost defaults to 0.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.campaign import grid as _grid
from repro_torch.campaign.engine import (EARLY_EXIT_CHUNK, run_campaign,
                                         run_ensemble)
from repro_torch.campaign.grid import CampaignGrid
from repro_torch.core import llg
from repro_torch.core.params import VariationSpec
from repro_torch.imc.write_margin import DEVICE_DT, params_for


@functools.lru_cache(maxsize=None)
def nominal_pulse(kind: str, v_write: float = 1.0, device=None) -> float:
    """Device-nominal per-attempt pulse [s]: the deterministic switching
    time x the 2% pulse margin (``circuit.subarray._characterize_write``)."""
    from repro_torch.circuit.subarray import _characterize_write

    t_sw, _ = _characterize_write(kind, float(v_write), device)
    return float(t_sw)


@dataclasses.dataclass(frozen=True)
class WritePolicy:
    """Write-verify scheduling knobs (hashable)."""

    v_write: float = 1.0
    pulse: Optional[float] = None     # per-attempt pulse [s]; None = nominal
    pulse_margin: float = 1.5         # x nominal when pulse is None
    max_attempts: int = 8
    t_rc: float = 40e-12              # driver line-charge overhead / attempt
    t_verify: float = 0.0             # verify read latency / attempt
    e_verify: float = 0.0             # verify read energy / attempt [J]
    temperature: Optional[float] = None   # None = device default (300 K)
    dt: Optional[float] = None        # None = per-device campaign step
    seed: int = 0
    use_cache: bool = True
    # one process corner (DESIGN.md §9): per-device D2D rows persist across
    # a cell's retries; sweep a multi-corner spec with write_verify_corners
    variation: Optional[VariationSpec] = None
    # each round's launch writes its result into its own state block
    # (DESIGN.md §14); the same float32 operations, so the schedule is
    # bit-identical to the undonated one
    donate: bool = False

    def resolved_pulse(self, kind: str, device=None) -> float:
        if self.pulse is not None:
            return float(self.pulse)
        return float(nominal_pulse(kind, self.v_write, device)
                     * self.pulse_margin)

    def resolved_dt(self, kind: str) -> float:
        return float(self.dt if self.dt is not None else DEVICE_DT[kind])

    @property
    def cycle_overhead(self) -> float:
        return self.t_rc + self.t_verify


@dataclasses.dataclass(frozen=True)
class ArrayWriteResult:
    """Measured write-verify statistics for one batch of cell writes."""

    kind: str
    policy: WritePolicy
    pulse: float                  # resolved per-attempt pulse [s]
    dt: float
    attempts: np.ndarray          # (cells,) pulses issued (1..max_attempts)
    success: np.ndarray           # (cells,) bool — verified within budget
    crossing_time: np.ndarray     # (cells,) [s]; NaN where never written
    energy: np.ndarray            # (cells,) total write energy [J]
    elapsed_s: float              # simulation wall clock
    rounds: int = 0               # retry rounds integrated

    @property
    def cycle(self) -> float:
        """One attempt's latency slot: line charge + pulse + verify."""
        return self.policy.cycle_overhead + self.pulse

    @property
    def latency(self) -> np.ndarray:
        """(cells,) total per-cell write latency [s]."""
        return self.attempts * self.cycle

    @property
    def attempts_mean(self) -> float:
        return float(self.attempts.mean()) if self.attempts.size else 0.0

    @property
    def residual_ber(self) -> float:
        return float(1.0 - self.success.mean()) if self.success.size else 0.0

    @property
    def single_pulse_wer(self) -> float:
        if not self.success.size:
            return 0.0
        return float(1.0 - (self.success & (self.attempts == 1)).mean())

    def latency_percentile(self, q) -> np.ndarray:
        return np.percentile(self.latency, q)

    def energy_mean(self) -> float:
        return float(self.energy.mean()) if self.energy.size else 0.0

    def retry_histogram(self) -> np.ndarray:
        """(max_attempts + 1,) count of cells by attempts used."""
        return np.bincount(self.attempts,
                           minlength=self.policy.max_attempts + 1)

    def row_attempts(self, cols: int) -> np.ndarray:
        """(rows,) attempts a row-granular controller pays per row (the
        max over the row's cells)."""
        cells = self.attempts.size
        assert cells % cols == 0, (cells, cols)
        return self.attempts.reshape(cells // cols, cols).max(axis=1)

    def row_latency_percentile(self, cols: int, q: float) -> float:
        return float(np.percentile(self.row_attempts(cols), q) * self.cycle)


def write_verify(kind: str, n_cells: int,
                 policy: WritePolicy = WritePolicy(),
                 device=None) -> ArrayWriteResult:
    """Write ``n_cells`` cells (P -> AP) through the retry scheduler.  Each
    round is one single-point campaign over the still-unwritten cells, with
    the round folded into the campaign seed (``policy.variation``: one
    ``run_ensemble`` launch on the variation plane per round)."""
    if policy.variation is not None:
        return _write_verify_variation(kind, n_cells, policy, device)
    p = params_for(kind)
    v = float(policy.v_write)
    pulse = policy.resolved_pulse(kind, device)
    dt = policy.resolved_dt(kind)
    temp = float(policy.temperature if policy.temperature is not None
                 else p.temperature)
    g_p = 1.0 / p.r_parallel
    g_ap = 1.0 / p.r_antiparallel
    e_rc = v * v * g_p * policy.t_rc

    attempts = np.zeros(n_cells, dtype=np.int64)
    success = np.zeros(n_cells, dtype=bool)
    crossing = np.full(n_cells, np.nan)
    energy = np.zeros(n_cells)
    remaining = np.arange(n_cells)

    t0 = time.perf_counter()
    rounds = 0
    for rnd in range(policy.max_attempts):
        if remaining.size == 0:
            break
        rounds += 1
        grid = CampaignGrid(
            voltages=(v,), pulse_widths=(pulse,), temperatures=(temp,),
            n_samples=int(remaining.size), dt=dt,
            seed=policy.seed * 1009 + rnd)
        res = run_campaign(p, grid, use_cache=policy.use_cache,
                           donate=policy.donate, device=device)
        ct = res.crossing_time[0, 0]                  # (remaining,)
        ok = ct <= pulse

        attempts[remaining] += 1
        e_att = np.where(ok,
                         v * v * (g_p * ct + g_ap * (pulse - ct)),
                         v * v * g_p * pulse)
        energy[remaining] += e_att + e_rc + policy.e_verify
        done = remaining[ok]
        success[done] = True
        crossing[done] = ct[ok]
        remaining = remaining[~ok]
    elapsed = time.perf_counter() - t0
    return ArrayWriteResult(kind=kind, policy=policy, pulse=pulse, dt=dt,
                            attempts=attempts, success=success,
                            crossing_time=crossing, energy=energy,
                            elapsed_s=elapsed, rounds=rounds)


def _write_verify_variation(kind: str, n_cells: int, policy: WritePolicy,
                            device=None) -> ArrayWriteResult:
    """Write-verify of one corner's sampled devices: one D2D draw fixes
    every cell's rows (alpha, B_k, g_scale on the kernel's variation plane;
    Brown sigma and tilt scale from its varied volume), and each round
    integrates the survivors through ``run_ensemble`` with their own
    rows."""
    p = params_for(kind)
    spec = policy.variation
    if spec is None or spec.n_corners != 1:
        raise ValueError("write_verify programs one corner's array; sweep "
                         "corners with write_verify_corners")
    dev = resolve_device(device)
    v = float(policy.v_write)
    pulse = policy.resolved_pulse(kind, device)
    dt = policy.resolved_dt(kind)
    temp = float(policy.temperature if policy.temperature is not None
                 else p.temperature)
    # one step past the pulse, so the never-crossed sentinel exceeds it
    n_steps = int(math.ceil(pulse / dt)) + 1

    rows = spec.lane_rows(p, spec.corners[0], n_cells, dt, temperature=temp)
    kernel_rows = rows.kernel_rows                      # (3, n_cells) f32
    g_p = (1.0 / p.r_parallel) * rows.g_scale           # per cell [S]
    g_ap = (1.0 / p.r_antiparallel) * rows.g_scale
    e_rc = v * v * g_p * policy.t_rc

    attempts = np.zeros(n_cells, dtype=np.int64)
    success = np.zeros(n_cells, dtype=bool)
    crossing = np.full(n_cells, np.nan)
    energy = np.zeros(n_cells)
    remaining = np.arange(n_cells)

    t0 = time.perf_counter()
    rounds = 0
    for rnd in range(policy.max_attempts):
        if remaining.size == 0:
            break
        rounds += 1
        m = int(remaining.size)
        seed_r = policy.seed * 1009 + rnd
        # a fresh tilt per round: the draws of a nominal round of this
        # seed, scaled by each survivor's own theta0
        round_grid = CampaignGrid(voltages=(v,), pulse_widths=(pulse,),
                                  temperatures=(temp,), n_samples=m, dt=dt,
                                  seed=seed_r)
        zs, ph = _grid.tilt_draws(round_grid, 0, m, dev)
        zs = torch.as_tensor(zs, dtype=torch.float32, device=dev)
        ph = torch.as_tensor(ph, dtype=torch.float32, device=dev)
        th0 = torch.as_tensor(rows.theta0[remaining], dtype=torch.float32,
                              device=dev)
        m0 = llg.initial_state(p, zs * th0 + 0.01, ph)
        res = run_ensemble(
            p, m0, torch.full((m,), v, dtype=torch.float32, device=dev), dt,
            n_steps, seed=seed_r, chunk=EARLY_EXIT_CHUNK,
            lane_params=kernel_rows[:, remaining],
            sigma_lanes=rows.sigma[remaining], donate=policy.donate,
            device=dev)
        ct = res.crossing_time                          # (m,) [s]
        ok = ct <= pulse

        attempts[remaining] += 1
        gp_r, gap_r = g_p[remaining], g_ap[remaining]
        e_att = np.where(ok,
                         v * v * (gp_r * ct + gap_r * (pulse - ct)),
                         v * v * gp_r * pulse)
        energy[remaining] += e_att + e_rc[remaining] + policy.e_verify
        done = remaining[ok]
        success[done] = True
        crossing[done] = ct[ok]
        remaining = remaining[~ok]
    elapsed = time.perf_counter() - t0
    return ArrayWriteResult(kind=kind, policy=policy, pulse=pulse, dt=dt,
                            attempts=attempts, success=success,
                            crossing_time=crossing, energy=energy,
                            elapsed_s=elapsed, rounds=rounds)


def write_verify_corners(kind: str, n_cells: int,
                         policy: WritePolicy = WritePolicy(),
                         spec: Optional[VariationSpec] = None,
                         device=None) -> Dict[str, ArrayWriteResult]:
    """One retry schedule per process corner of ``spec`` (default:
    ``policy.variation``), ``{corner name: ArrayWriteResult}``.  Corners
    share D2D draws and per-round tilts and thermal streams, so their
    differences are paired per cell."""
    spec = spec if spec is not None else policy.variation
    if spec is None:
        raise ValueError("write_verify_corners needs a VariationSpec")
    return {corner.name: write_verify(
                kind, n_cells,
                dataclasses.replace(policy, variation=spec.at_corner(ci)),
                device)
            for ci, corner in enumerate(spec.corners)}


def program_bits(target: np.ndarray, kind: str = "afmtj",
                 policy: WritePolicy = WritePolicy(),
                 current: Optional[np.ndarray] = None,
                 device=None) -> Tuple[ArrayWriteResult, np.ndarray]:
    """Program a (rows, cols) bit matrix: pulses go only to cells whose
    target differs from ``current`` (default: an erased all-zeros array),
    both directions modelled by the P -> AP transient.  Returns the flipped
    cells' write statistics and the residual bit-error map (cells still
    stale after ``policy.max_attempts``)."""
    target = np.asarray(target)
    if target.ndim != 2:
        raise ValueError(f"program_bits takes a 2-D bit matrix, got shape "
                         f"{target.shape}")
    cur = (np.zeros_like(target) if current is None
           else np.asarray(current))
    flip = target != cur
    res = write_verify(kind, int(flip.sum()), policy, device)
    error_map = np.zeros(target.shape, dtype=bool)
    error_map[flip] = ~res.success
    return res, error_map


@dataclasses.dataclass(frozen=True)
class MeasuredWrite:
    """Distribution summary the subarray timing model consumes."""

    t_write: float            # row write time at ``percentile`` [s]
    e_write_bit: float        # mean per-cell write energy [J]
    attempts_mean: float      # per-cell mean pulses
    attempts_row_mean: float  # mean over rows of the per-row max
    single_pulse_wer: float
    residual_ber: float
    pulse: float              # per-attempt pulse [s]
    percentile: float


@functools.lru_cache(maxsize=None)
def measured_write_timings(
    kind: str,
    v_write: float = 1.0,
    cols: int = 256,
    percentile: float = 99.0,
    t_rc: float = 40e-12,
    pulse: Optional[float] = None,
    max_attempts: int = 8,
    n_rows: int = 16,
    seed: int = 0,
    use_cache: bool = True,
    variation: Optional[VariationSpec] = None,
    device=None,
) -> MeasuredWrite:
    """Row-granular write timing from the measured retry distribution:
    ``n_rows`` rows of ``cols`` cells through ``write_verify``, reduced to
    the ``percentile`` row write time and the mean per-bit energy;
    ``variation`` (one corner) measures a process corner's devices."""
    policy = WritePolicy(v_write=float(v_write), pulse=pulse, t_rc=float(t_rc),
                         max_attempts=int(max_attempts), seed=int(seed),
                         use_cache=use_cache, variation=variation)
    res = write_verify(kind, int(cols) * int(n_rows), policy, device)
    row_att = res.row_attempts(int(cols))
    return MeasuredWrite(
        t_write=res.row_latency_percentile(int(cols), float(percentile)),
        e_write_bit=res.energy_mean(),
        attempts_mean=res.attempts_mean,
        attempts_row_mean=float(row_att.mean()),
        single_pulse_wer=res.single_pulse_wer,
        residual_ber=res.residual_ber,
        pulse=res.pulse,
        percentile=float(percentile),
    )


@dataclasses.dataclass(frozen=True)
class WriteSurface:
    """Measured write statistics over (temperature x voltage x pulse)."""

    kind: str
    voltages: Tuple[float, ...]
    pulses: Tuple[float, ...]
    temperatures: Tuple[float, ...]
    residual_ber: np.ndarray     # (n_T, n_V, n_P)
    attempts_mean: np.ndarray    # (n_T, n_V, n_P)
    latency_mean: np.ndarray     # (n_T, n_V, n_P) [s]
    energy_mean: np.ndarray      # (n_T, n_V, n_P) [J]


def write_surface(kind: str, voltages: Tuple[float, ...] = (1.0,),
                  pulses: Optional[Tuple[float, ...]] = None,
                  temperatures: Optional[Tuple[float, ...]] = None,
                  n_cells: int = 256,
                  policy: WritePolicy = WritePolicy(),
                  device=None) -> WriteSurface:
    """Residual bit-error / retry / cost maps vs the write operating point:
    one ``write_verify`` schedule per (T, V, pulse) point, the temperature
    through ``WritePolicy.temperature``.  ``pulses=None`` uses the
    device-nominal pulse only."""
    p = params_for(kind)
    pulses = tuple(float(x) for x in (
        pulses if pulses is not None
        else (policy.resolved_pulse(kind, device),)))
    temperatures = tuple(float(x) for x in (
        temperatures if temperatures is not None else (p.temperature,)))
    voltages = tuple(float(x) for x in voltages)
    shape = (len(temperatures), len(voltages), len(pulses))
    ber = np.zeros(shape)
    att = np.zeros(shape)
    lat = np.zeros(shape)
    en = np.zeros(shape)
    for ti, temp in enumerate(temperatures):
        for vi, v in enumerate(voltages):
            for pi, pw in enumerate(pulses):
                pol = dataclasses.replace(policy, v_write=v, pulse=pw,
                                          temperature=temp)
                r = write_verify(kind, n_cells, pol, device)
                ber[ti, vi, pi] = r.residual_ber
                att[ti, vi, pi] = r.attempts_mean
                lat[ti, vi, pi] = float(r.latency.mean())
                en[ti, vi, pi] = r.energy_mean()
    return WriteSurface(kind=kind, voltages=voltages, pulses=pulses,
                        temperatures=temperatures, residual_ber=ber,
                        attempts_mean=att, latency_mean=lat, energy_mean=en)
