"""Campaign grids: (voltage x pulse x temperature x sample) -> SoA tiles.

Port of ``repro.campaign.grid``.  Pulse width is post-processing (the
kernel records each lane's first-crossing step), and temperature rides the
lanes as a per-lane Brown sigma, so a whole (T x V x S) grid is one kernel
launch.  Lane counts are padded to power-of-two multiples of ``CELL_TILE``
(``bucket_cells``); padded lanes carry a step budget of 0.

The Boltzmann tilts of the initial states are drawn by ``tilt_draws`` from
a ``torch.Generator`` seeded with (grid.seed, slice): the reference draws
them with ``jax.random``, so the port's campaigns are statistically, not
sample for sample, the reference's at the same seed.  The per-step thermal
streams (``kernels.noise``) are bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import llg
from repro_torch.core.device import thermal_theta0
from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import DeviceParams
from repro_torch.kernels import noise
from repro_torch.kernels.ops import pack_states
from repro_torch.kernels.ref import CELL_TILE


@dataclasses.dataclass(frozen=True)
class CampaignGrid:
    """Axes of one Monte-Carlo campaign (hashable: the cache key)."""

    voltages: Tuple[float, ...]
    pulse_widths: Tuple[float, ...]          # [s], post-processing axis
    temperatures: Tuple[float, ...] = (300.0,)
    n_samples: int = 64
    dt: float = 0.1e-12
    seed: int = 0
    switch_threshold: float = 0.9

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
        """(n_T, n_V, n_P, n_S) — the result surface axes."""
        return (len(self.temperatures), len(self.voltages),
                len(self.pulse_widths), self.n_samples)


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (lane buckets and compiled horizons)."""
    assert n > 0, n
    return 1 << (n - 1).bit_length()


def bucket_cells(cells: int) -> int:
    """Smallest power-of-two multiple of ``CELL_TILE`` >= ``cells``."""
    assert cells > 0, cells
    return CELL_TILE * next_pow2(-(-cells // CELL_TILE))


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
