"""Campaign grids: (voltage x pulse x temperature x sample) -> SoA tiles.

Port of ``repro.campaign.grid``.  Pulse width is post-processing (the
kernel records each lane's first-crossing step), temperature rides the
lanes as a per-lane Brown sigma, and process corners ride them as per-lane
device-parameter rows on the kernel's variation plane (``pack_variation``,
DESIGN.md §9), so a whole (corner x T x V x S) grid is one kernel launch.
Lane counts are padded to power-of-two multiples of ``CELL_TILE``
(``bucket_cells``); padded lanes carry a step budget of 0.

Every corner of a variation grid shares the nominal plane's tilt draws and
thermal streams (common random numbers), so a fused corner campaign equals
the same corners launched one at a time, bit for bit.  Retention sweeps span
decades of horizon: ``log_pulses`` gives their pulse ladder and
``log_horizon_bucket`` the geometric ladder of integration horizons that
the engine's ``horizon="log"`` rounds up to (DESIGN.md §10).

The Boltzmann tilts of the initial states are drawn by ``tilt_draws`` from
a ``torch.Generator`` seeded with (grid.seed, slice): the reference draws
them with ``jax.random``, so the port's campaigns are statistically, not
sample for sample, the reference's at the same seed.  The per-step thermal
streams (``kernels.noise``) are bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import llg
from repro_torch.core.device import thermal_theta0
from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import DeviceParams, VariationSpec
from repro_torch.kernels import noise
from repro_torch.kernels.ops import pack_states
from repro_torch.kernels.ref import CELL_TILE


@dataclasses.dataclass(frozen=True)
class CampaignGrid:
    """Axes of one Monte-Carlo campaign (hashable: the cache key).
    ``variation`` adds the process-corner axis: corner count and values are
    launch data, packed corner-major ahead of the temperature slices."""

    voltages: Tuple[float, ...]
    pulse_widths: Tuple[float, ...]          # [s], post-processing axis
    temperatures: Tuple[float, ...] = (300.0,)
    n_samples: int = 64
    dt: float = 0.1e-12
    seed: int = 0
    switch_threshold: float = 0.9
    variation: Optional[VariationSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "voltages", tuple(float(v) for v in self.voltages))
        # ascending: pulse_for_wer returns the smallest qualifying pulse
        object.__setattr__(self, "pulse_widths",
                           tuple(sorted(float(t) for t in self.pulse_widths)))
        object.__setattr__(self, "temperatures",
                           tuple(float(t) for t in self.temperatures))
        if not (self.voltages and self.pulse_widths and self.temperatures
                and self.n_samples > 0):
            raise ValueError(f"empty campaign grid: {self}")

    @property
    def n_steps(self) -> int:
        """Horizon covering the longest pulse plus one step, so the
        never-crossed sentinel (crossing step == n_steps) strictly exceeds
        every pulse width."""
        return int(math.ceil(max(self.pulse_widths) / self.dt)) + 1

    @property
    def cells(self) -> int:
        """Real (unpadded) lanes of one (voltage x sample) plane."""
        return len(self.voltages) * self.n_samples

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """(n_T, n_V, n_P, n_S) — the result surface axes (a variation
        grid's corner axis, ``n_corners``, comes before them)."""
        return (len(self.temperatures), len(self.voltages),
                len(self.pulse_widths), self.n_samples)

    @property
    def n_corners(self) -> int:
        return 1 if self.variation is None else self.variation.n_corners


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (lane buckets and compiled horizons)."""
    assert n > 0, n
    return 1 << (n - 1).bit_length()


def bucket_cells(cells: int) -> int:
    """Smallest power-of-two multiple of ``CELL_TILE`` >= ``cells``."""
    assert cells > 0, cells
    return CELL_TILE * next_pow2(-(-cells // CELL_TILE))


HORIZON_RUNGS_PER_DECADE = 2


def log_horizon_bucket(n_steps: int,
                       per_decade: int = HORIZON_RUNGS_PER_DECADE) -> int:
    """Smallest rung of the geometric step-count ladder
    ``round(10**(k / per_decade))``, k >= 0, that is >= ``n_steps``: the
    horizon ladder of decade-spanning (retention) campaigns.  The per-lane
    budget stops real lanes at the true horizon, so the rung changes no
    crossing row."""
    assert n_steps > 0, n_steps
    assert per_decade > 0, per_decade
    k = max(0, math.ceil(per_decade * math.log10(n_steps)))
    while k > 0 and round(10 ** ((k - 1) / per_decade)) >= n_steps:
        k -= 1
    while round(10 ** (k / per_decade)) < n_steps:
        k += 1
    return int(round(10 ** (k / per_decade)))


def log_pulses(t_min: float, t_max: float, per_decade: int = 4
               ) -> Tuple[float, ...]:
    """Log-spaced pulse-width ladder [s], endpoints included: one
    integration to ``t_max`` gives the survival fraction at every rung."""
    assert 0 < t_min < t_max, (t_min, t_max)
    n = max(2, int(round(per_decade * math.log10(t_max / t_min))) + 1)
    return tuple(float(t) for t in np.geomspace(t_min, t_max, n))


def pack_soa(m0: torch.Tensor, voltages: torch.Tensor) -> torch.Tensor:
    """(cells, n_sub, 3) states + (cells,) drives -> ``(8, bucket)`` SoA.
    Single-sublattice states keep rows 3-5 at zero."""
    cells = m0.shape[0]
    target = bucket_cells(cells)
    voltages = voltages.to(torch.float32)
    if m0.shape[1] == 2:
        state = pack_states(m0, voltages)
        return torch.nn.functional.pad(state, (0, target - state.shape[1]))
    assert m0.shape[1] == 1, tuple(m0.shape)
    pad = target - cells
    m0 = torch.nn.functional.pad(m0, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(voltages, (0, pad))
    z = torch.zeros_like(v)
    rows = [m0[:, 0, 0], m0[:, 0, 1], m0[:, 0, 2], z, z, z, v, z]
    return torch.stack(rows).to(torch.float32)


def tilt_draws(grid: CampaignGrid, t_index: int, cells: int, device):
    """Boltzmann tilt normals |N(0,1)| and azimuths U(0, 2 pi) of one
    (V x S) plane, from a CPU ``torch.Generator`` seeded with
    (grid.seed, t_index) — the same draws on every device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(grid.seed) * 1_000_003 + int(t_index)) % (2**63))
    zs = torch.randn(cells, generator=gen, dtype=torch.float32).abs()
    ph = torch.rand(cells, generator=gen, dtype=torch.float32) * (2 * math.pi)
    return zs.to(device), ph.to(device)


def pack_plane(grid: CampaignGrid, p: DeviceParams, t_index: int, device):
    """Pack the (voltage x sample) plane of one temperature slice.

    Returns ``(state, seeds)``: the ``(8, bucket)`` SoA block and its
    per-lane thermal stream seeds (int32 bit patterns of uint32 values).  Sample ``s`` of voltage ``v_i``
    lands at lane ``i * n_samples + s``.  Initial states: |N(0,1)| *
    theta_eq + 0.01 tilt, uniform azimuth.
    """
    n_s = grid.n_samples
    cells = grid.cells
    zs, ph = tilt_draws(grid, t_index, cells, device)
    zs = torch.as_tensor(zs, dtype=torch.float32, device=device)
    ph = torch.as_tensor(ph, dtype=torch.float32, device=device)
    th = zs * thermal_theta0(p) + 0.01
    m0 = llg.initial_state(p, th, ph)
    v = torch.tensor(grid.voltages, dtype=torch.float32,
                     device=device).repeat_interleave(n_s)
    state = pack_soa(m0, v)
    seeds = noise.slice_seeds(grid.seed, t_index, state.shape[1], device)
    return state, seeds


def pack_campaign(grid: CampaignGrid, p: DeviceParams, device):
    """One SoA block for the whole (T x V x S) grid: each temperature slice
    packed as ``pack_plane`` packs it, slices concatenated along the lanes.

    Returns ``(state, seeds, sigma, budget, spans)``: the ``(8, cells)``
    block, per-lane stream seeds, per-lane Brown sigma [T], per-lane step
    budget (``grid.n_steps`` on real lanes, 0 on padding) and
    ``spans[ti] = (start, stop)``, the real lanes of slice ``ti``.
    """
    states, seed_rows, sigma_rows, budget_rows, spans = [], [], [], [], []
    offset = 0
    for ti, temp in enumerate(grid.temperatures):
        p_t = (p if temp == p.temperature
               else dataclasses.replace(p, temperature=float(temp)))
        st, sd = pack_plane(grid, p_t, ti, device)
        padded = st.shape[1]
        lane = torch.arange(padded, device=device)
        states.append(st)
        seed_rows.append(sd)
        sigma_rows.append(torch.full((padded,), thermal_sigma(p_t, grid.dt),
                                     dtype=torch.float32, device=device))
        budget_rows.append(torch.where(lane < grid.cells, float(grid.n_steps),
                                       0.0).to(torch.float32))
        spans.append((offset, offset + grid.cells))
        offset += padded
    return (torch.cat(states, dim=1), torch.cat(seed_rows),
            torch.cat(sigma_rows), torch.cat(budget_rows), spans)


def pack_variation(grid: CampaignGrid, p: DeviceParams, device):
    """One SoA block for the whole (corner x T x V x S) grid of a
    variation grid (DESIGN.md §9).

    Corner-major: slice ``ci * n_T + ti`` is corner ``ci`` at temperature
    ``ti``, packed with the nominal plane's tilt draws (``tilt_draws``)
    scaled by each lane's own theta0, the thermal streams of
    ``noise.slice_seeds(seed, ti)`` (shared by every corner), and the
    spec's D2D rows (``VariationSpec.lane_rows``, salted by the temperature
    index, not the corner).

    Returns ``(state, seeds, sigma, budget, lane_params, spans)``: as
    ``pack_campaign`` plus the ``(3, cells)`` variation rows (alpha, B_k,
    g_scale), with ``spans[ci * n_T + ti]`` the real lanes of each slice.
    Padding lanes carry nominal rows, sigma 0 and budget 0.
    """
    spec = grid.variation
    assert spec is not None, "pack_variation needs grid.variation"
    n_steps = float(grid.n_steps)
    cells = grid.cells
    f32 = torch.float32
    v = torch.tensor(grid.voltages, dtype=f32,
                     device=device).repeat_interleave(grid.n_samples)
    states, seed_rows, sigma_rows, budget_rows, lane_rows, spans = (
        [], [], [], [], [], [])
    offset = 0
    for corner in spec.corners:
        for ti, temp in enumerate(grid.temperatures):
            rows = spec.lane_rows(p, corner, cells, grid.dt,
                                  temperature=temp, stream=ti)
            zs, ph = tilt_draws(grid, ti, cells, device)
            zs = torch.as_tensor(zs, dtype=f32, device=device)
            ph = torch.as_tensor(ph, dtype=f32, device=device)
            th0 = torch.as_tensor(rows.theta0, dtype=f32, device=device)
            st = pack_soa(llg.initial_state(p, zs * th0 + 0.01, ph), v)
            padded = st.shape[1]
            pad = padded - cells

            def row(vals, fill):
                return torch.from_numpy(np.pad(
                    np.asarray(vals, np.float64), (0, pad),
                    constant_values=fill).astype(np.float32)).to(device)

            states.append(st)
            seed_rows.append(noise.slice_seeds(grid.seed, ti, padded, device))
            sigma_rows.append(row(rows.sigma, 0.0))
            budget_rows.append(row(np.full(cells, n_steps), 0.0))
            lane_rows.append(torch.stack([row(rows.alpha, p.alpha),
                                          row(rows.b_aniso, p.b_aniso),
                                          row(rows.g_scale, 1.0)]))
            spans.append((offset, offset + cells))
            offset += padded
    return (torch.cat(states, dim=1), torch.cat(seed_rows),
            torch.cat(sigma_rows), torch.cat(budget_rows),
            torch.cat(lane_rows, dim=1), spans)
