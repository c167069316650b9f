"""Stochastic write path: write-verify programming through LLG transients.

Port of ``repro.imc.write_path`` for the nominal device (no process
variation).  A write-verify scheduler programs cells through thermal LLG
transients: one fixed-width pulse per cell (a single-point campaign through
``campaign.run_campaign``), success read off the first-crossing row, and
only failed cells re-pulsed with fresh thermal samples, up to
``max_attempts`` rounds.  Out come measured per-cell latency / energy,
retry counts and the residual bit-error rate.

Conventions (as the reference): attempts are independent thermal trials
(fresh tilt and noise stream per round); per-attempt energy charges G_P up
to the crossing and G_AP for the pulse remainder (failed attempts: G_P for
the whole pulse), plus the driver line-charge overhead ``t_rc`` at G_P;
verify cost defaults to 0.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np

from repro_torch.campaign.engine import run_campaign
from repro_torch.campaign.grid import CampaignGrid
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

    def energy_mean(self) -> float:
        return float(self.energy.mean()) if self.energy.size else 0.0

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
    the round folded into the campaign seed."""
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
        res = run_campaign(p, grid, use_cache=policy.use_cache, device=device)
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
    device=None,
) -> MeasuredWrite:
    """Row-granular write timing from the measured retry distribution:
    ``n_rows`` rows of ``cols`` cells through ``write_verify``, reduced to
    the ``percentile`` row write time and the mean per-bit energy."""
    policy = WritePolicy(v_write=float(v_write), pulse=pulse, t_rc=float(t_rc),
                         max_attempts=int(max_attempts), seed=int(seed),
                         use_cache=use_cache)
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
