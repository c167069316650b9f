"""Measured read path: read disturb, retention, sense-margin yield.

Port of ``repro.imc.read_path`` (DESIGN.md §10).  Three measured scenario
families; the first two ride the fused campaign engine (one launch of the
LLG kernel per campaign: temperature, voltage and process corners on the
lanes, pulse width as first-crossing post-processing), the third is a
closed-form Monte-Carlo in plain PyTorch on the caller's device.

**Read disturb** (``read_disturb_campaign``): a read pulse is a
sub-threshold STT drive, so the campaign is the write campaign at
read-scale voltages with a first crossing counted as the error
(disturb probability = 1 - WER).  At operating bias the probability is far
below Monte-Carlo resolution, so ``fit_disturb_model`` fits the read-bias
barrier suppression Delta_eff(V) = Delta (1 - V/V_c)^beta on a
barrier-scaled corner, where escapes are measurable, and transfers the
shape to the real barrier (V_c follows the exchange-dominated Neel-STT
threshold, which barrier scaling leaves alone: the accelerated-stress
assumption).  ``accumulated_disturb`` / ``reads_between_refresh`` turn the
per-read probability into a read budget.

**Retention** (``retention_campaign``): at Delta = 40 no escape happens in a
feasible horizon, so acceleration corners scale ``b_aniso_factor`` down to
Delta_eff ~ 2-6, every (real corner x acceleration x T) combination in one
fused launch on the log horizon ladder (``campaign.grid.log_pulses``, the
engine's ``horizon="log"``).  Escape times reduce by censored-exponential
MLE, a free Arrhenius fit cross-checks the closed-form Delta, and the
operating point extrapolates with the slope pinned to 1:
tau_op = tau0 exp(Delta_op).

**Sense-margin yield** (``sense_margin_yield``): input-referred sense-amp
offsets (``circuit.senseamp.sa_offsets``) plus per-lane junction-resistance
draws (``VariationSpec``, common random numbers across corners and
read-voltage rungs).  A read fails when the offset flips the bit-line
differential's sign or (with a budget) the latch time exceeds it;
``size_read_drive`` walks a read-voltage / transimpedance ladder per corner.

``measured_read_timings`` feeds ``circuit.subarray.make_subarray(...,
read_percentile=...)`` and ``derive_refresh_policy`` turns measured
retention and the disturb budget into the scrub interval ``imc.evaluate``
charges into Fig. 4.  The reference's ``backend=`` becomes ``device=``:
the campaigns run the LLG kernel on the card and its plain version on the
CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.params import (CORNER_FF, CORNER_SS, CORNER_TT, KB,
                                     DeviceParams, VariationSpec)
from repro_torch.imc.write_margin import DEVICE_DT, params_for


def _delta_at(p: DeviceParams, temperature: float,
              b_factor: float = 1.0, v_factor: float = 1.0) -> float:
    """Closed-form thermal stability Delta = E_b / kT of a corner device."""
    e_b = 0.5 * p.b_aniso * b_factor * p.ms * p.volume * v_factor
    return e_b / (KB * float(temperature))


# --- read disturb -----------------------------------------------------------
# Default disturb ladder: from the operating read bias (0.1 V) across the
# AFMTJ Neel-STT onset (~0.19 V) into the thermally assisted regime.  Below
# onset the measured probability is 0 at any feasible sample count, and
# ``p1_upper`` bounds it.
DISTURB_VOLTAGES = (0.10, 0.15, 0.20, 0.24)
DISTURB_PULSES = (0.2e-9, 0.8e-9, 2.0e-9)


@dataclasses.dataclass(frozen=True)
class ReadDisturbResult:
    """Disturb-flip probability surfaces from one fused campaign."""

    kind: str
    result: "object"        # campaign.engine.CampaignResult

    @property
    def grid(self):
        return self.result.grid

    @property
    def n_launches(self) -> int:
        return self.result.n_launches

    def disturb_surface(self) -> np.ndarray:
        """(..., n_T, n_V, n_P) per-read disturb-flip probability (leading
        corner axis on variation grids): 1 - WER."""
        return 1.0 - self.result.wer_surface()

    def p1(self, v_index: int = 0, p_index: int = -1, t_index: int = 0,
           corner_index: Optional[int] = None) -> float:
        """Measured per-read disturb probability at one operating point
        (worst corner by default on variation grids)."""
        s = self.disturb_surface()
        if s.ndim == 4:
            s = s.max(axis=0) if corner_index is None else s[corner_index]
        return float(s[t_index, v_index, p_index])

    def p1_upper(self, v_index: int = 0, p_index: int = -1, t_index: int = 0,
                 corner_index: Optional[int] = None) -> float:
        """The measured estimate plus the rule-of-three 95% bound 3/n: a
        measured zero means "below 3/n_samples"."""
        return (self.p1(v_index, p_index, t_index, corner_index)
                + 3.0 / self.grid.n_samples)


def accumulated_disturb(p1: float, n_reads: float) -> float:
    """P(bit corrupted after ``n_reads`` independent reads) = 1-(1-p1)^N."""
    if p1 <= 0.0:
        return 0.0
    if p1 >= 1.0:
        return 1.0
    return float(-math.expm1(n_reads * math.log1p(-p1)))


def reads_between_refresh(p1: float, ber_budget: float) -> float:
    """Largest N with accumulated disturb <= ``ber_budget``."""
    if p1 <= 0.0:
        return math.inf
    if p1 >= 1.0:
        return 0.0
    return math.log1p(-ber_budget) / math.log1p(-p1)


def read_disturb_campaign(
    kind: str = "afmtj",
    voltages: Tuple[float, ...] = DISTURB_VOLTAGES,
    pulses: Tuple[float, ...] = DISTURB_PULSES,
    temperatures: Tuple[float, ...] = (300.0, 400.0),
    n_samples: int = 256,
    variation: Optional[VariationSpec] = None,
    seed: int = 0,
    use_cache: bool = True,
    device=None,
) -> ReadDisturbResult:
    """Disturb-flip probability vs (read voltage, pulse, T, corner): one
    fused launch of the write campaign at read-scale voltages, the stored
    bit starting in its Boltzmann-tilted well."""
    from repro_torch.campaign.engine import run_campaign
    from repro_torch.campaign.grid import CampaignGrid

    p = params_for(kind)
    grid = CampaignGrid(
        voltages=tuple(float(v) for v in voltages),
        pulse_widths=tuple(float(t) for t in pulses),
        temperatures=tuple(float(t) for t in temperatures),
        n_samples=int(n_samples), dt=DEVICE_DT[kind], seed=seed,
        variation=variation)
    res = run_campaign(p, grid, use_cache=use_cache, device=device)
    return ReadDisturbResult(kind=kind, result=res)


# --- accelerated disturb model ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DisturbModel:
    """Fitted read-bias barrier suppression Delta_eff(V) = Delta s(V),
    s(V) = (1 - V/V_c)^beta below V_c (0 above), fitted on an acceleration
    corner (``accel_factor`` x the nominal barrier)."""

    kind: str
    v_c: float                    # fitted critical voltage [V]
    beta: float                   # fitted suppression exponent
    accel_factor: float           # barrier scale the fit ran at
    delta_acc: float              # closed-form Delta of the fit corner
    tau0_acc: float               # zero-bias attempt time of the fit [s]
    voltages: Tuple[float, ...]   # fit ladder
    tau_meas: Tuple[float, ...]   # measured escape times per rung [s]
    sse: float                    # fit residual (sum sq. error in ln s)

    def suppression(self, v: float) -> float:
        if v >= self.v_c:
            return 0.0
        return (1.0 - v / self.v_c) ** self.beta

    def tau_disturb(self, v: float, delta_op: float, tau0: float) -> float:
        """Escape time under read bias ``v`` for a device of zero-bias
        barrier ``delta_op`` and attempt time ``tau0``."""
        return tau0 * math.exp(delta_op * self.suppression(v))

    def p1(self, v: float, t_read: float, delta_op: float, tau0: float
           ) -> float:
        """Per-read disturb probability: P(escape within one read pulse)."""
        tau = self.tau_disturb(v, delta_op, tau0)
        return float(-math.expm1(-t_read / tau))


def _censored_tau(ct: np.ndarray, horizon: float) -> Tuple[float, int]:
    """Censored-exponential MLE on first-crossing times: tau = total
    observed time / escapes (inf when nothing escaped)."""
    flips = int((ct <= horizon).sum())
    total = float(np.minimum(ct, horizon).sum())
    return (total / flips if flips else math.inf), flips


def fit_disturb_model(
    kind: str = "afmtj",
    accel_factor: float = 0.1,
    voltages: Tuple[float, ...] = (0.0, 0.05, 0.10, 0.15),
    horizon: float = 4.0e-9,
    n_samples: int = 256,
    temperature: Optional[float] = None,
    seed: int = 11,
    use_cache: bool = True,
    device=None,
) -> DisturbModel:
    """Fit (V_c, beta) on a barrier-accelerated corner — one fused launch on
    the log horizon ladder.  The ladder must hold 0 (it anchors
    ``tau0_acc``) and at least two biased rungs with escapes; raises
    ValueError otherwise."""
    from repro_torch.campaign.engine import run_campaign
    from repro_torch.campaign.grid import CampaignGrid

    if 0.0 not in voltages:
        raise ValueError("the ladder must anchor the zero-bias escape time")
    p = params_for(kind)
    temp = float(temperature if temperature is not None else p.temperature)
    corner = dataclasses.replace(CORNER_TT, name=f"tt~{accel_factor:g}",
                                 b_aniso_factor=float(accel_factor))
    grid = CampaignGrid(
        voltages=tuple(float(v) for v in voltages),
        pulse_widths=(float(horizon),), temperatures=(temp,),
        n_samples=int(n_samples), dt=DEVICE_DT[kind], seed=seed,
        variation=VariationSpec(corners=(corner,)))
    res = run_campaign(p, grid, use_cache=use_cache, horizon="log",
                       device=device)

    taus, flips = [], []
    for vi in range(len(grid.voltages)):
        tau, n = _censored_tau(res.crossing_time[0, 0, vi], float(horizon))
        taus.append(tau)
        flips.append(n)
    v0 = grid.voltages.index(0.0)
    if not math.isfinite(taus[v0]):
        raise ValueError(
            f"no zero-bias escapes at accel={accel_factor:g} within "
            f"{horizon * 1e9:g} ns; lower accel_factor or widen the horizon")
    delta_acc = _delta_at(p, temp, b_factor=accel_factor)
    tau0_acc = taus[v0] / math.exp(delta_acc)

    # suppression samples at the biased rungs with observed escapes
    pts = [(v, math.log(tau / tau0_acc) / delta_acc)
           for v, tau, n in zip(grid.voltages, taus, flips)
           if v > 0.0 and n >= 3 and math.isfinite(tau)]
    pts = [(v, s) for v, s in pts if s > 1e-3]
    if len(pts) < 2:
        raise ValueError(
            "fewer than 2 biased rungs with escapes; widen the ladder or "
            "the horizon")
    vs = np.array([v for v, _ in pts])
    ln_s = np.log(np.clip([s for _, s in pts], 1e-6, 1.0))

    # for a fixed V_c, beta is closed-form least squares in
    # ln s = beta ln(1 - V/V_c); scan V_c above the largest rung and keep
    # the least-SSE pair
    best = None
    for v_c in np.linspace(vs.max() * 1.05, 0.6, 120):
        x = np.log1p(-vs / v_c)
        beta = float((ln_s * x).sum() / (x * x).sum())
        sse = float(((beta * x - ln_s) ** 2).sum())
        if best is None or sse < best[2]:
            best = (float(v_c), beta, sse)
    v_c, beta, sse = best
    return DisturbModel(kind=kind, v_c=v_c, beta=beta,
                        accel_factor=float(accel_factor),
                        delta_acc=delta_acc, tau0_acc=tau0_acc,
                        voltages=grid.voltages,
                        tau_meas=tuple(taus), sse=sse)


# --- retention ----------------------------------------------------------------
# Acceleration ladder: Delta_eff = 40 f in the measurable 2-6 window
ACCEL_FACTORS = (0.05, 0.10, 0.15)

# Band of the free Arrhenius slope that counts as activated escape (the
# attempt time itself depends on the scaled anisotropy, so over Delta_eff
# 2-6 the apparent slope departs from the asymptotic 1)
ARRHENIUS_SLOPE_BAND = (0.6, 1.8)


def default_retention_spec(seed: int = 0) -> VariationSpec:
    """The real corners retention is signed off against (no D2D: the
    closed-form Delta of the extrapolation is a corner quantity)."""
    return VariationSpec(corners=(CORNER_TT, CORNER_SS, CORNER_FF),
                         seed=seed)


@dataclasses.dataclass(frozen=True)
class RetentionResult:
    """Measured accelerated-stress retention per (real corner, T)."""

    kind: str
    spec: VariationSpec                 # the real corners
    accel_factors: Tuple[float, ...]
    result: "object"                    # composed-corner CampaignResult
    min_flips: int = 3                  # rungs below this stay out of fits

    @property
    def grid(self):
        return self.result.grid

    @property
    def n_launches(self) -> int:
        return self.result.n_launches

    @property
    def temperatures(self) -> Tuple[float, ...]:
        return self.grid.temperatures

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.spec.n_corners, len(self.temperatures),
                len(self.accel_factors))

    @functools.cached_property
    def _mle(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tau, n_flips), each (n_corners, n_T, n_accel): the censored-
        exponential MLE of every composed slice."""
        n_c, n_t, n_f = self.shape
        horizon = float(max(self.grid.pulse_widths))
        tau = np.empty((n_c, n_t, n_f))
        flips = np.empty((n_c, n_t, n_f), dtype=np.int64)
        ct = self.result.crossing_time      # (n_c * n_f, n_T, 1, n_S)
        for ci in range(n_c):
            for fi in range(n_f):
                for ti in range(n_t):
                    t, n = _censored_tau(ct[ci * n_f + fi, ti, 0], horizon)
                    tau[ci, ti, fi] = t
                    flips[ci, ti, fi] = n
        return tau, flips

    @property
    def tau_acc(self) -> np.ndarray:
        """(n_corners, n_T, n_accel) measured escape times [s]."""
        return self._mle[0]

    @property
    def n_flips(self) -> np.ndarray:
        return self._mle[1]

    def delta_eff(self) -> np.ndarray:
        """(n_corners, n_T, n_accel) closed-form Delta of each composed
        acceleration corner (corner factors only)."""
        p = params_for(self.kind)
        n_c, n_t, n_f = self.shape
        out = np.empty((n_c, n_t, n_f))
        for ci, corner in enumerate(self.spec.corners):
            for ti, temp in enumerate(self.temperatures):
                for fi, f in enumerate(self.accel_factors):
                    out[ci, ti, fi] = _delta_at(
                        p, temp, b_factor=corner.b_aniso_factor * f,
                        v_factor=corner.volume_factor)
        return out

    def delta_op(self) -> np.ndarray:
        """(n_corners, n_T) closed-form operating-point Delta."""
        p = params_for(self.kind)
        return np.array([
            [_delta_at(p, temp, b_factor=c.b_aniso_factor,
                       v_factor=c.volume_factor)
             for temp in self.temperatures]
            for c in self.spec.corners])

    def _valid(self, ci: int, ti: int) -> np.ndarray:
        tau, flips = self._mle
        return (flips[ci, ti] >= self.min_flips) & np.isfinite(tau[ci, ti])

    def arrhenius_fit(self, corner_index: int = 0, t_index: int = 0
                      ) -> Tuple[float, float]:
        """Free weighted fit ln tau = ln tau0 + slope Delta_eff over the
        measurable rungs (the cross-check against the closed-form Delta):
        (slope, ln_tau0), NaNs with fewer than 2 measurable rungs."""
        ok = self._valid(corner_index, t_index)
        if ok.sum() < 2:
            return math.nan, math.nan
        tau, flips = self._mle
        x = self.delta_eff()[corner_index, t_index][ok]
        y = np.log(tau[corner_index, t_index][ok])
        w = flips[corner_index, t_index][ok].astype(float)
        xm, ym = np.average(x, weights=w), np.average(y, weights=w)
        slope = float(np.average((x - xm) * (y - ym), weights=w)
                      / np.average((x - xm) ** 2, weights=w))
        return slope, float(ym - slope * xm)

    def tau0(self, corner_index: int = 0, t_index: int = 0) -> float:
        """Attempt time [s] with the Arrhenius slope pinned to 1 (the
        stable quantity to extrapolate with)."""
        ok = self._valid(corner_index, t_index)
        if not ok.any():
            return math.nan
        tau, flips = self._mle
        ln_tau0 = (np.log(tau[corner_index, t_index][ok])
                   - self.delta_eff()[corner_index, t_index][ok])
        return float(math.exp(np.average(
            ln_tau0, weights=flips[corner_index, t_index][ok].astype(float))))

    def tau_op(self) -> np.ndarray:
        """(n_corners, n_T) extrapolated escape time [s]: tau0 exp(Delta_op)."""
        d_op = self.delta_op()
        n_c, n_t = d_op.shape
        return np.array([[self.tau0(ci, ti) * math.exp(d_op[ci, ti])
                          for ti in range(n_t)] for ci in range(n_c)])

    def retention_percentiles(self, qs=(1e-9, 1e-6, 0.01)) -> np.ndarray:
        """(n_corners, n_T, len(qs)) time [s] by which a fraction ``q`` of
        bits has flipped: -tau_op ln(1 - q)."""
        tau = self.tau_op()[..., None]
        q = np.asarray(qs, dtype=float)
        return -tau * np.log1p(-q)

    def worst_tau_op(self) -> float:
        """Smallest extrapolated escape time over (corner, T): what a
        refresh policy must cover."""
        return float(np.nanmin(self.tau_op()))


def retention_horizons(kind: str = "afmtj") -> Tuple[float, ...]:
    """Default log-spaced survival-time ladder [s] of the acceleration
    window (4 ns AFMTJ, 8 ns MTJ, three rungs per decade)."""
    from repro_torch.campaign.grid import log_pulses

    hi = 4.0e-9 if kind == "afmtj" else 8.0e-9
    return log_pulses(hi / 20.0, hi, per_decade=3)


def retention_campaign(
    kind: str = "afmtj",
    accel_factors: Tuple[float, ...] = ACCEL_FACTORS,
    temperatures: Tuple[float, ...] = (300.0,),
    horizons: Optional[Tuple[float, ...]] = None,
    n_samples: int = 256,
    variation: Optional[VariationSpec] = None,
    v_hold: float = 0.0,
    seed: int = 5,
    use_cache: bool = True,
    device=None,
) -> RetentionResult:
    """Accelerated-stress retention: one fused launch over every (real
    corner x acceleration x T) combination, on the log horizon ladder.
    Accelerations compose onto each real corner's own ``b_aniso_factor``
    (packed corner-major), so corner ordering is preserved; ``v_hold`` is
    a biased standby rail (0: idle retention)."""
    from repro_torch.campaign.engine import run_campaign
    from repro_torch.campaign.grid import CampaignGrid

    p = params_for(kind)
    spec = variation if variation is not None else default_retention_spec()
    accel = tuple(float(f) for f in accel_factors)
    if not all(0.0 < f <= 1.0 for f in accel):
        raise ValueError(f"acceleration factors must lie in (0, 1]: {accel}")
    composed = tuple(
        dataclasses.replace(c, name=f"{c.name}~{f:g}",
                            b_aniso_factor=c.b_aniso_factor * f)
        for c in spec.corners for f in accel)
    horizons = (tuple(float(h) for h in horizons) if horizons is not None
                else retention_horizons(kind))
    grid = CampaignGrid(
        voltages=(float(v_hold),), pulse_widths=horizons,
        temperatures=tuple(float(t) for t in temperatures),
        n_samples=int(n_samples), dt=DEVICE_DT[kind], seed=seed,
        variation=dataclasses.replace(spec, corners=composed))
    res = run_campaign(p, grid, use_cache=use_cache, horizon="log",
                       device=device)
    return RetentionResult(kind=kind, spec=spec, accel_factors=accel,
                           result=res)


# --- sense-margin yield ---------------------------------------------------------
# D2D junction-resistance spread the read margin is signed off against
READ_D2D_SIGMA_R = 0.05
DEFAULT_OFFSET_SIGMA = 5e-3       # input-referred SA offset std [V]


def default_read_spec(seed: int = 0) -> VariationSpec:
    """tt/ss/ff corners with the read path's D2D resistance spread."""
    return VariationSpec(corners=tuple(
        dataclasses.replace(c, sigma_r=READ_D2D_SIGMA_R)
        for c in (CORNER_TT, CORNER_SS, CORNER_FF)), seed=seed)


@dataclasses.dataclass(frozen=True)
class SenseYieldResult:
    """Monte-Carlo read yield over (corner x read-voltage ladder)."""

    kind: str
    v_reads: Tuple[float, ...]
    corner_names: Tuple[str, ...]
    r_trans: float
    offset_sigma: float
    n_samples: int
    percentile: float
    yield_surface: np.ndarray      # (n_corners, n_V) fraction read correctly
    t_sense: np.ndarray            # (n_corners, n_V) [s] at ``percentile``
    margin_min: np.ndarray         # (n_corners, n_V) [V] worst lane margin

    def v_read_for_yield(self, target: float,
                         corner_index: Optional[int] = None) -> float:
        """Smallest ladder read voltage with yield >= target (worst corner
        by default); raises when no rung qualifies."""
        y = (self.yield_surface.min(axis=0) if corner_index is None
             else self.yield_surface[corner_index])
        ok = np.nonzero(y >= target)[0]
        if not ok.size:
            raise ValueError(
                f"no ladder v_read reaches yield {target:g} (best "
                f"{y.max():.6g}); widen the ladder or raise r_trans")
        return float(self.v_reads[ok[0]])


def sense_margin_yield(
    kind: str = "afmtj",
    v_reads: Tuple[float, ...] = (0.05, 0.1, 0.15, 0.2),
    sa=None,
    bl=None,
    variation: Optional[VariationSpec] = None,
    n_samples: int = 4096,
    seed: int = 0,
    t_budget: Optional[float] = None,
    percentile: float = 99.0,
    ref_trim: str = "corner",
    device=None,
) -> SenseYieldResult:
    """Read-yield Monte-Carlo: per lane a junction draw (the spec's D2D
    resistance factor, common to every corner and rung) and a sense-amp
    offset (``sa_offsets``).  A read is correct when both stored states
    resolve with the right sign (and within ``t_budget``); ``t_sense`` is
    the ``percentile`` latch time over lanes of the slower state.  The
    conductances and latch times are float32 tensors on ``device``, the
    rest float64 on the host, as in the reference.

    ``ref_trim="corner"`` trims the reference column to each corner's own
    mid-point; ``"nominal"`` pins it to the nominal device's, which exposes
    the systematic corner shift no read voltage can buy back."""
    from repro_torch.circuit.bitline import BitlineParams, cell_conductance
    from repro_torch.circuit.senseamp import (SenseAmpParams, sa_offsets,
                                             sense_delay)

    if ref_trim not in ("corner", "nominal"):
        raise ValueError(f"ref_trim must be 'corner' or 'nominal': {ref_trim}")
    dev = resolve_device(device)
    f32 = torch.float32
    p = params_for(kind)
    sa = sa if sa is not None else SenseAmpParams(
        offset_sigma=DEFAULT_OFFSET_SIGMA)
    bl = bl if bl is not None else BitlineParams()
    spec = variation if variation is not None else default_read_spec()
    n = int(n_samples)
    offsets_t = sa_offsets(sa, n, seed=seed, device=dev)
    offsets = offsets_t.double().cpu().numpy()

    def gc(g):
        return cell_conductance(torch.as_tensor(g, dtype=f32, device=dev),
                                bl).double().cpu().numpy()

    def delay(di):
        return sense_delay(torch.as_tensor(di, dtype=f32, device=dev), sa,
                           offset=offsets_t).double().cpu().numpy()

    g_p, g_ap = 1.0 / p.r_parallel, 1.0 / p.r_antiparallel
    n_c, n_v = spec.n_corners, len(v_reads)
    yld = np.empty((n_c, n_v))
    t_s = np.empty((n_c, n_v))
    mrg = np.empty((n_c, n_v))
    for ci, corner in enumerate(spec.corners):
        # junction draw: common to every corner (salted by stream)
        g_scale = 1.0 / spec.lane_factors(corner, n, stream=0)[3]
        gp_eff = gc(g_p * g_scale)
        gap_eff = gc(g_ap * g_scale)
        # reference column at the trim target's level mid-point
        f_ref = 1.0 if ref_trim == "nominal" else 1.0 / corner.r_factor
        g_ref = 0.5 * (gc(g_p * f_ref) + gc(g_ap * f_ref))
        for vi, v in enumerate(v_reads):
            di_p = v * (gp_eff - g_ref)         # must resolve positive
            di_ap = v * (gap_eff - g_ref)       # must resolve negative
            dv_p = di_p * sa.r_trans + offsets
            dv_ap = di_ap * sa.r_trans + offsets
            correct = (dv_p > 0.0) & (dv_ap < 0.0)
            t_lane = np.maximum(delay(di_p), delay(di_ap))
            if t_budget is not None:
                correct &= t_lane <= t_budget
            yld[ci, vi] = correct.mean()
            t_s[ci, vi] = np.percentile(t_lane, percentile)
            mrg[ci, vi] = min(dv_p.min(), -dv_ap.max())
    return SenseYieldResult(
        kind=kind, v_reads=tuple(float(v) for v in v_reads),
        corner_names=spec.corner_names, r_trans=float(sa.r_trans),
        offset_sigma=float(sa.offset_sigma), n_samples=n,
        percentile=float(percentile), yield_surface=yld, t_sense=t_s,
        margin_min=mrg)


@dataclasses.dataclass(frozen=True)
class SizedRead:
    """Per-corner read drive sizing (the read analog of the WER-margined
    write pulse)."""

    v_read: float
    r_trans: float
    read_yield: float
    t_sense: float        # [s] at the sizing percentile


def size_read_drive(
    kind: str = "afmtj",
    yield_target: float = 0.999,
    v_reads: Tuple[float, ...] = (0.05, 0.1, 0.15, 0.2),
    r_trans_ladder: Optional[Tuple[float, ...]] = None,
    sa=None,
    variation: Optional[VariationSpec] = None,
    n_samples: int = 4096,
    seed: int = 0,
    t_budget: Optional[float] = None,
    device=None,
) -> Dict[str, SizedRead]:
    """Smallest (v_read, r_trans) per corner meeting the yield target: the
    read-voltage ladder (least disturb first) within each transimpedance
    rung, on common random numbers.  A corner that never reaches the
    target gets its best point (``read_yield`` says it missed)."""
    from repro_torch.circuit.senseamp import SenseAmpParams

    sa = sa if sa is not None else SenseAmpParams(
        offset_sigma=DEFAULT_OFFSET_SIGMA)
    rt_ladder = (tuple(float(r) for r in r_trans_ladder)
                 if r_trans_ladder is not None else (sa.r_trans,))
    spec = variation if variation is not None else default_read_spec()
    results = {}
    for rt in sorted(rt_ladder):
        sy = sense_margin_yield(
            kind, v_reads=v_reads, sa=dataclasses.replace(sa, r_trans=rt),
            variation=spec, n_samples=n_samples, seed=seed,
            t_budget=t_budget, device=device)
        for ci, name in enumerate(sy.corner_names):
            if name in results and results[name].read_yield >= yield_target:
                continue
            y = sy.yield_surface[ci]
            ok = np.nonzero(y >= yield_target)[0]
            vi = int(ok[0]) if ok.size else int(np.argmax(y))
            cand = SizedRead(v_read=sy.v_reads[vi], r_trans=rt,
                             read_yield=float(y[vi]),
                             t_sense=float(sy.t_sense[ci, vi]))
            if (name not in results
                    or cand.read_yield > results[name].read_yield):
                results[name] = cand
    return results


@dataclasses.dataclass(frozen=True)
class MeasuredRead:
    """Distribution summary the subarray timing model consumes."""

    t_sense: float        # latch time at ``percentile``, worst corner
    read_yield: float     # worst-corner fraction of correct resolutions
    margin_min: float     # worst-lane margin [V] (negative: failing lane)
    v_read: float
    offset_sigma: float
    percentile: float


@functools.lru_cache(maxsize=None)
def measured_read_timings(
    kind: str,
    v_read: float = 0.1,
    percentile: float = 99.0,
    sa=None,
    bl=None,
    variation: Optional[VariationSpec] = None,
    n_samples: int = 4096,
    seed: int = 0,
    device=None,
) -> MeasuredRead:
    """The worst corner's sense time at the controller percentile and the
    worst yield, from one ``sense_margin_yield`` at the operating read
    voltage (every argument hashable: lru-cached across hierarchy
    builds)."""
    sy = sense_margin_yield(kind, v_reads=(float(v_read),), sa=sa, bl=bl,
                            variation=variation, n_samples=n_samples,
                            seed=seed, percentile=percentile, device=device)
    worst = int(np.argmax(sy.t_sense[:, 0]))
    return MeasuredRead(
        t_sense=float(sy.t_sense[worst, 0]),
        read_yield=float(sy.yield_surface.min()),
        margin_min=float(sy.margin_min.min()),
        v_read=float(v_read),
        offset_sigma=float(sy.offset_sigma),
        percentile=float(percentile))


# --- refresh policy -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """Scrub schedule derived from measured read-path reliability (pure,
    hashable data; ``imc.evaluate`` charges it from each level's own
    timings)."""

    interval: float              # [s] scrub period (inf = never)
    limited_by: str              # "retention" | "disturb" | "none"
    tau_retention: float         # worst-corner extrapolated escape time [s]
    p1_read: float               # per-read disturb prob. at the read bias
    reads_max: float             # disturb-limited reads between scrubs
    ber_budget: float
    reads_per_cell_s: float


@functools.lru_cache(maxsize=None)
def derive_refresh_policy(
    kind: str = "afmtj",
    ber_budget: float = 1e-9,
    reads_per_cell_s: float = 1e6,
    v_read: float = 0.05,
    t_read: float = 0.5e-9,
    n_samples: int = 256,
    seed: int = 5,
    use_cache: bool = True,
    device=None,
) -> RefreshPolicy:
    """Scrub interval from measured physics, the tighter of the
    retention-limited interval (P(flip) <= budget under the worst corner's
    extrapolated tau, ``retention_campaign``) and the disturb-limited one
    (budget-compliant reads at the read bias under ``fit_disturb_model`` /
    the cell read rate).  The default read bias is derated to 0.05 V: at
    the nominal 0.1 V the fitted model gives p1 ~ 1e-5 per read, which no
    scrub can absorb at a 1e-9 budget."""
    ret = retention_campaign(kind, n_samples=n_samples, seed=seed,
                             use_cache=use_cache, device=device)
    tau_w = ret.worst_tau_op()
    t_ret = -tau_w * math.log1p(-ber_budget)

    model = fit_disturb_model(kind, n_samples=n_samples, seed=seed + 6,
                              use_cache=use_cache, device=device)
    # worst corner for disturb: the smallest extrapolated barrier
    d_op = ret.delta_op()
    ci, ti = np.unravel_index(np.argmin(d_op), d_op.shape)
    p1 = model.p1(float(v_read), float(t_read), float(d_op[ci, ti]),
                  ret.tau0(int(ci), int(ti)))
    n_max = reads_between_refresh(p1, ber_budget)
    t_dist = n_max / float(reads_per_cell_s)

    interval = min(t_ret, t_dist)
    limited = "retention" if t_ret <= t_dist else "disturb"
    if math.isinf(interval):
        limited = "none"
    return RefreshPolicy(interval=float(interval), limited_by=limited,
                         tau_retention=float(tau_w), p1_read=float(p1),
                         reads_max=float(n_max),
                         ber_budget=float(ber_budget),
                         reads_per_cell_s=float(reads_per_cell_s))
