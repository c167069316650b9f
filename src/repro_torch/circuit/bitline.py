"""Bit-line RC transient model (port of ``repro.circuit.bitline``).

A bit line with capacitance C_bl = rows * c_cell + c_fixed discharges
through the activated cells (access transistor R_on in series with the
junction): V_bl(t) = V_pre exp(-t G_eff / C_bl), so settle and charge
times are closed-form.  Tensor inputs are float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.params import DeviceParams


@dataclasses.dataclass(frozen=True)
class BitlineParams:
    c_per_cell: float = 0.03e-15   # drain + wire capacitance per attached cell [F]
    c_fixed: float = 2.0e-15       # SA input + periphery capacitance [F]
    r_access: float = 1.0e3        # access transistor on-resistance [Ohm]
    r_driver: float = 200.0        # write-driver output resistance [Ohm]
    r_wire_per_cell: float = 0.5   # bit-line wire resistance per row segment [Ohm]
    t_wl_setup: float = 20e-12     # word-line decode/assert overhead [s]
    v_precharge: float = 1.0       # precharge level [V]
    v_read: float = 0.1            # read voltage across the cell [V]
    rows: int = 256

    @property
    def c_total(self) -> float:
        return self.rows * self.c_per_cell + self.c_fixed


def cell_conductance(g_junction: torch.Tensor, bl: BitlineParams) -> torch.Tensor:
    """Series combination of access transistor and junction."""
    return g_junction / (1.0 + bl.r_access * g_junction)


def bitline_settle_time(g_junction: torch.Tensor, bl: BitlineParams,
                        settle_frac: float = 0.95) -> torch.Tensor:
    """t = ln(1/(1-frac)) * C_bl / G_eff (float32, as the reference)."""
    g_eff = cell_conductance(g_junction, bl)
    ln = torch.log(torch.tensor(1.0 / (1.0 - settle_frac), dtype=torch.float32,
                                device=g_eff.device))
    return ln * bl.c_total / g_eff


def write_path_rc(bl: BitlineParams, settle_frac: float = 0.95) -> float:
    """Write-path overhead: the driver (not the cell) charges the bit line."""
    return (math.log(1.0 / (1.0 - settle_frac)) * bl.r_driver * bl.c_total
            + bl.t_wl_setup)


def column_ir_drop(g_column_total: torch.Tensor,
                   bl: BitlineParams) -> torch.Tensor:
    """Per-column IR-drop attenuation for multi-row analog MVM:
    1 / (1 + R_line G_col) with R_line = r_wire * rows / 2, the one-segment
    lumped bit line (``g_column_total`` = summed effective cell
    conductance of the column)."""
    r_line = bl.r_wire_per_cell * bl.rows / 2.0
    return 1.0 / (1.0 + r_line * g_column_total)


def multi_row_current(bits: torch.Tensor, dev: DeviceParams,
                      bl: BitlineParams) -> torch.Tensor:
    """Aggregate read current [A] for multi-row activation: bits
    (..., n_rows) in {0, 1}, 1 = parallel (low-R) state."""
    g_p = torch.tensor(1.0 / dev.r_parallel, dtype=torch.float32,
                       device=bits.device)
    g_ap = torch.tensor(1.0 / dev.r_antiparallel, dtype=torch.float32,
                        device=bits.device)
    g_cells = torch.where(bits > 0, g_p, g_ap)
    g_eff = cell_conductance(g_cells, bl)
    return bl.v_read * torch.sum(g_eff, dim=-1)


def logic_current_levels(n_rows: int, dev: DeviceParams, bl: BitlineParams,
                         device) -> torch.Tensor:
    """The n_rows+1 current levels for k parallel-state cells (k = 0..n_rows)."""
    f32 = torch.float32
    g_p = cell_conductance(torch.tensor(1.0 / dev.r_parallel, dtype=f32,
                                        device=device), bl)
    g_ap = cell_conductance(torch.tensor(1.0 / dev.r_antiparallel, dtype=f32,
                                         device=device), bl)
    k = torch.arange(n_rows + 1, device=device)
    return bl.v_read * (k * g_p + (n_rows - k) * g_ap)
