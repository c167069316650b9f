"""Public entry points of the port's kernels and the SoA packing helpers
(port of ``repro.kernels.ops``)."""
from __future__ import annotations

import torch

from repro_torch.core.params import DeviceParams
from repro_torch.kernels.bitline_mac import bitline_mac_kernel
from repro_torch.kernels.llg_rk4 import CELL_TILE, llg_rk4_kernel
from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel


def llg_rk4(state: torch.Tensor, p: DeviceParams, dt: float, n_steps: int,
            switch_threshold: float = 0.9) -> torch.Tensor:
    """Advance a (8, cells) state block n_steps, no thermal field."""
    return llg_rk4_kernel(state, p, dt, n_steps, switch_threshold)


def llg_rk4_thermal(state, seeds, p: DeviceParams, dt: float, n_steps: int,
                    thermal_sigma, switch_threshold: float = 0.9,
                    step_budget=None, chunk: int = 0, lane_params=None):
    """Thermal (Langevin) variant: per-cell counter-RNG streams in
    ``seeds``, per-lane (or scalar) Brown sigma, optional per-lane step
    budget, chunked early exit and variation rows."""
    return llg_rk4_kernel(state, p, dt, n_steps, switch_threshold,
                          thermal_sigma=thermal_sigma, seeds=seeds,
                          step_budget=step_budget, chunk=chunk,
                          lane_params=lane_params)


def pack_states(m0: torch.Tensor, voltages: torch.Tensor) -> torch.Tensor:
    """(cells, 2, 3) initial states + (cells,) drives -> (8, cells) SoA,
    padded with zero lanes to a multiple of ``CELL_TILE``."""
    assert m0.dim() == 3 and m0.shape[1] == 2, (
        f"SoA layout here is dual-sublattice (AFMTJ), got {tuple(m0.shape)}; "
        "single-sublattice states pack via repro_torch.campaign.grid.pack_soa")
    cells = m0.shape[0]
    pad = (-cells) % CELL_TILE
    m0 = torch.nn.functional.pad(m0, (0, 0, 0, 0, 0, pad))
    voltages = torch.nn.functional.pad(voltages, (0, pad))
    rows = [m0[:, 0, 0], m0[:, 0, 1], m0[:, 0, 2],
            m0[:, 1, 0], m0[:, 1, 1], m0[:, 1, 2],
            voltages, torch.zeros_like(voltages)]
    return torch.stack(rows).to(torch.float32)


def unpack_states(state: torch.Tensor, cells: int):
    m = torch.stack([state[0:3, :cells].T, state[3:6, :cells].T], dim=1)
    crossing_step = state[7, :cells]
    return m, crossing_step


def bitline_mac(v: torch.Tensor, g: torch.Tensor, adc_bits: int = 0,
                i_max: float = 1.0) -> torch.Tensor:
    """Bit-line MAC ``v @ g`` through the signed ADC (0 bits = ideal)."""
    return bitline_mac_kernel(v, g, adc_bits, i_max)


def xnor_gemm(a: torch.Tensor, w: torch.Tensor, binarize: bool = False,
              tie: int = 1) -> torch.Tensor:
    """+-1 GEMM (= K - 2 popcount(a XOR w)), optionally re-binarized."""
    return xnor_gemm_kernel(a, w, binarize, tie)
