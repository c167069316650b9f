"""Monte-Carlo campaign engine: one kernel launch for the whole campaign.

Port of ``repro.campaign.engine`` in dense mode on one device.  Every
campaign axis that is not post-processing rides the kernel's lanes: voltage
x sample x temperature (Brown's sigma is a per-lane input) x process corner
(per-lane alpha, B_k and conductance-factor rows on the kernel's variation
plane, ``grid.pack_variation``), pulse width falls out of the recorded
first-crossing steps.  The kernel integrates in chunks and a block of lanes
leaves as soon as each of its lanes has crossed or used its step budget
(``EARLY_EXIT_CHUNK``); the horizon passed to it is rounded up to a rung
(a power of two, or with ``horizon="log"`` the geometric ladder of
``grid.log_horizon_bucket``) while the budget row stops real lanes at the
true horizon, so crossing rows equal a fixed-horizon run's.  Corner count
and values are launch data: every variation campaign runs the kernel's one
variation instance, whatever its corners.

Both device kinds integrate through ``kernels.llg_rk4.llg_rk4_kernel``: the
CUDA kernel for CUDA tensors (dual- or single-sublattice), its plain
PyTorch version for CPU tensors.  Results are reduced on the host into WER
and latency-percentile surfaces and cached on disk (``cache.py``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.campaign import cache as _cache
from repro_torch.campaign.grid import (CampaignGrid, bucket_cells,
                                       log_horizon_bucket, next_pow2,
                                       pack_campaign, pack_soa,
                                       pack_variation)
from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import DeviceParams
from repro_torch.kernels import noise
from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

# Early-exit granularity [steps]: a block checks "is every lane done?" once
# per chunk.
EARLY_EXIT_CHUNK = 64


def backend_tag(device: torch.device) -> str:
    """Which path integrates on ``device``: the CUDA kernel or its plain
    PyTorch version."""
    return "cuda-kernel" if device.type == "cuda" else "cpu-plain"


def brown_sigma(p: DeviceParams, dt: float, temperature: Optional[float] = None
                ) -> float:
    """Brown's thermal-field std per component per step [T]."""
    if temperature is not None and temperature != p.temperature:
        p = dataclasses.replace(p, temperature=float(temperature))
    return thermal_sigma(p, dt)


def _quantize_steps(n_steps: int, horizon: str = "pow2") -> int:
    """Horizon passed to the kernel: the next power of two (``"pow2"``) or
    the next rung of the geometric ladder (``"log"``, for decade-spanning
    retention campaigns).  The per-lane budget row stops every real lane at
    the true horizon."""
    if horizon == "log":
        return log_horizon_bucket(n_steps)
    if horizon != "pow2":
        raise ValueError(f"horizon must be 'pow2' or 'log', got {horizon!r}")
    return next_pow2(n_steps)


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """One thermal ensemble integration."""
    final_state: np.ndarray      # (8, cells) SoA at loop exit
    crossing_steps: np.ndarray   # (cells,) first crossing (== n_steps: none)
    n_steps: int
    dt: float
    elapsed_s: float
    backend: str = ""

    @property
    def crossing_time(self) -> np.ndarray:
        return self.crossing_steps * self.dt

    @property
    def switched(self) -> np.ndarray:
        return self.crossing_steps < self.n_steps


def run_ensemble(
    p: DeviceParams,
    m0: torch.Tensor,                # (cells, n_sub, 3) initial states
    voltages,                        # (cells,) per-cell drive
    dt: float,
    n_steps: int,
    *,
    seed: int = 0,
    temperature: Optional[float] = None,
    switch_threshold: float = 0.9,
    chunk: int = 0,
    lane_params=None,                # optional (3, cells) variation rows
    sigma_lanes=None,                # optional (cells,) per-lane Brown sigma
    horizon: str = "pow2",           # horizon ladder (chunk > 0)
    device=None,
) -> EnsembleResult:
    """Integrate an arbitrary thermal ensemble through the kernel path.

    ``temperature=None`` uses ``p.temperature``.  ``chunk > 0`` turns on
    chunked early exit: crossing rows equal the fixed-horizon run's, but
    ``final_state`` then holds the at-exit state, and the horizon given to
    the kernel is rounded up to a rung of ``horizon``'s ladder (the budget
    row stops real lanes at ``n_steps``).  ``lane_params`` ((3, cells):
    alpha, B_k, g_scale) switches on the kernel's per-lane variation plane
    and ``sigma_lanes`` replaces the scalar Brown sigma with a per-lane row
    (``VariationSpec.lane_rows`` gives both).  Never-switched lanes report
    ``crossing_steps == n_steps``.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    cells = m0.shape[0]
    state = pack_soa(torch.as_tensor(m0, dtype=f32, device=dev),
                     torch.as_tensor(voltages, dtype=f32, device=dev))
    padded = state.shape[1]
    if sigma_lanes is not None:
        sigma = torch.nn.functional.pad(
            torch.as_tensor(np.asarray(sigma_lanes, np.float64)
                            .astype(np.float32), device=dev),
            (0, padded - cells))
    else:
        sigma = torch.full((padded,), brown_sigma(p, dt, temperature),
                           dtype=f32, device=dev)
    budget = torch.where(torch.arange(padded, device=dev) < cells,
                         float(n_steps), 0.0).to(f32)
    if lane_params is not None:
        lp = np.asarray(lane_params, np.float64)
        assert lp.shape == (3, cells), (lp.shape, cells)
        fill = np.broadcast_to(np.array([[p.alpha], [p.b_aniso], [1.0]]),
                               (3, padded - cells))
        lane_params = torch.from_numpy(np.concatenate(
            [lp, fill], axis=1).astype(np.float32)).to(dev)
    seeds = noise.cell_seeds(seed, padded, dev)
    n_kernel = _quantize_steps(n_steps, horizon) if chunk > 0 else n_steps
    t0 = time.perf_counter()
    out = llg_rk4_kernel(state, p, dt, n_kernel, switch_threshold,
                         thermal_sigma=sigma, seeds=seeds, step_budget=budget,
                         chunk=int(chunk), lane_params=lane_params)
    out = out.cpu().numpy()
    elapsed = time.perf_counter() - t0
    return EnsembleResult(
        final_state=out[:, :cells],
        crossing_steps=np.minimum(out[7, :cells].astype(np.float64),
                                  float(n_steps)),
        n_steps=n_steps, dt=dt, elapsed_s=elapsed, backend=backend_tag(dev))


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    """WER / latency surfaces over the (T, V, pulse) axes of a grid, with a
    leading process-corner axis when the grid carries a ``VariationSpec``
    (``crossing_time`` is then (n_C, n_T, n_V, n_S), and every surface
    grows the same leading axis)."""
    grid: CampaignGrid
    backend: str                     # "cuda-kernel" or "cpu-plain"
    crossing_time: np.ndarray        # (n_T, n_V, n_S) [s]; variation
                                     # grids: (n_C, n_T, n_V, n_S)
    elapsed_s: float                 # integration wall clock (0 on cache hit)
    from_cache: bool = False
    n_launches: int = 1              # kernel launches (0 on a cache hit)

    @property
    def corners(self) -> Optional[Tuple[str, ...]]:
        """Corner names of the leading axis (None for nominal grids)."""
        return (None if self.grid.variation is None
                else self.grid.variation.corner_names)

    def wer_surface(self) -> np.ndarray:
        """(..., n_T, n_V, n_P) write-error rate: fraction of thermal
        samples NOT switched by the end of each pulse width (leading axis:
        process corners, on variation grids)."""
        pulses = np.asarray(self.grid.pulse_widths)
        ct = self.crossing_time[..., None, :]             # (..., V, 1, S)
        return (ct > pulses[:, None]).mean(axis=-1)

    def wer(self, t_index: int = 0, corner_index: int = 0) -> np.ndarray:
        """(n_V, n_P) slice at one temperature (and corner, if any)."""
        w = self.wer_surface()
        return w[corner_index, t_index] if w.ndim == 4 else w[t_index]

    def latency_percentiles(self, qs: Sequence[float] = (50.0, 99.0)
                            ) -> np.ndarray:
        """(..., n_T, n_V, len(qs)) switching-latency percentiles over
        switched samples (NaN where no sample switched; leading corner axis
        on variation grids)."""
        horizon = self.grid.n_steps * self.grid.dt
        ct = np.where(self.crossing_time < horizon, self.crossing_time, np.nan)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "All-NaN slice encountered")
            out = np.nanpercentile(ct, np.asarray(qs, dtype=float), axis=-1)
        return np.moveaxis(out, 0, -1)

    def pulse_for_wer(self, wer_target: float, t_index: int = 0,
                      v_index: Optional[int] = None,
                      corner_index: Optional[int] = None) -> float:
        """Smallest grid pulse width whose WER <= target, at the lowest grid
        voltage by default (the worst-case drive); on a variation grid
        ``corner_index=None`` takes the worst corner at every pulse.
        Raises if none qualifies."""
        if v_index is None:
            v_index = int(np.argmin(self.grid.voltages))
        surface = self.wer_surface()
        if surface.ndim == 4:
            surface = (surface.max(axis=0) if corner_index is None
                       else surface[corner_index])
        w = surface[t_index][v_index]
        pulses = np.asarray(self.grid.pulse_widths)
        ok = np.nonzero(w <= wer_target)[0]
        if not ok.size:
            raise ValueError(
                f"no grid pulse meets WER<={wer_target:g} (best WER "
                f"{w.min():.3g} at {pulses[-1]*1e12:.0f} ps); widen "
                "pulse_widths or raise the drive voltage")
        return float(pulses[ok[0]])


def run_campaign(
    p: DeviceParams,
    grid: CampaignGrid,
    *,
    use_cache: bool = True,
    cache_dir: Optional[str] = None,
    chunk: int = EARLY_EXIT_CHUNK,
    horizon: str = "pow2",
    device=None,
) -> CampaignResult:
    """Run (or cache-load) a full Monte-Carlo campaign: the whole (corner x
    T x V x S) grid in one kernel call on one device.  ``chunk=0`` disables
    early exit and the rounded horizon (the exact fixed-horizon launch);
    ``horizon`` picks the ladder the horizon is rounded up to ("pow2", or
    "log" for decade-spanning retention sweeps).  Crossing rows do not
    depend on the ladder, so both cache under one key.  A variation grid
    pads the whole plane to a power-of-two bucket, so the corner count
    reaches the launch shape only through that bucket."""
    dev = resolve_device(device)
    backend = backend_tag(dev)
    spec = grid.variation
    n_t, n_v, _, n_s = grid.shape
    expect_shape = ((grid.n_corners, n_t, n_v, n_s) if spec is not None
                    else (n_t, n_v, n_s))
    key = _cache.campaign_key(p, grid, backend)
    if use_cache:
        hit = _cache.load(key, cache_dir)
        if hit is not None and hit.shape == expect_shape:
            return CampaignResult(grid=grid, backend=backend,
                                  crossing_time=hit, elapsed_s=0.0,
                                  from_cache=True, n_launches=0)
    n_steps = grid.n_steps
    n_kernel = _quantize_steps(n_steps, horizon) if chunk > 0 else n_steps
    if spec is None:
        state, seeds, sigma, budget, spans = pack_campaign(grid, p, dev)
        lane_params = None
    else:
        state, seeds, sigma, budget, lane_params, spans = pack_variation(
            grid, p, dev)
        # total-plane bucket: budget-0 padding with nominal rows (alpha >
        # 0, g_scale 1: zero rows would divide 0 by 0)
        pad = bucket_cells(state.shape[1]) - state.shape[1]
        if pad:
            state = torch.nn.functional.pad(state, (0, pad))
            seeds = torch.nn.functional.pad(seeds, (0, pad))
            sigma = torch.nn.functional.pad(sigma, (0, pad))
            budget = torch.nn.functional.pad(budget, (0, pad))
            fill = torch.tensor([[p.alpha], [p.b_aniso], [1.0]],
                                dtype=torch.float32, device=dev)
            lane_params = torch.cat([lane_params, fill.expand(3, pad)],
                                    dim=1)
    t0 = time.perf_counter()
    out = llg_rk4_kernel(state, p, grid.dt, n_kernel,
                         float(grid.switch_threshold), thermal_sigma=sigma,
                         seeds=seeds, step_budget=budget, chunk=int(chunk),
                         lane_params=lane_params)
    row7 = out[7].cpu().numpy()
    elapsed = time.perf_counter() - t0
    # clip the rounded-up horizon's sentinel back to the grid's, in float64
    # before the dt multiply (in float32 n_steps*dt rounds below the f64
    # horizon and never-crossed lanes would count as switched)
    row7 = np.minimum(row7.astype(np.float64), float(n_steps))
    crossing = np.empty(expect_shape)
    for si, (lo, hi) in enumerate(spans):
        plane = row7[lo:hi].reshape(n_v, n_s) * grid.dt
        if spec is None:
            crossing[si] = plane
        else:
            crossing[si // n_t, si % n_t] = plane
    if use_cache:
        _cache.store(key, crossing,
                     header={"params": dataclasses.asdict(p),
                             "grid": dataclasses.asdict(grid),
                             "backend": backend},
                     cache_dir=cache_dir)
    return CampaignResult(grid=grid, backend=backend, crossing_time=crossing,
                          elapsed_s=elapsed)
