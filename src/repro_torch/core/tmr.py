"""Tunneling magnetoresistance readout model (paper Sec. II).

Port of ``repro.core.tmr``: Julliere-type angular conductance

    G(theta) = G_P (1 + cos theta)/2 + G_AP (1 - cos theta)/2,

with the Neel vector's z component in place of cos(theta) for the AFMTJ.
"""
from __future__ import annotations

import torch

from repro_torch.core.llg import const, order_parameter_z
from repro_torch.core.params import DeviceParams


def conductance_from_cos(cos_theta: torch.Tensor, p: DeviceParams) -> torch.Tensor:
    g_p = 1.0 / p.r_parallel
    g_ap = 1.0 / p.r_antiparallel
    return (const(0.5 * (g_p + g_ap), cos_theta)
            + const(0.5 * (g_p - g_ap), cos_theta) * cos_theta)


def conductance(m: torch.Tensor, p: DeviceParams) -> torch.Tensor:
    """Instantaneous junction conductance [S] from the state (..., n_sub, 3)."""
    return conductance_from_cos(order_parameter_z(m), p)


def resistance(m: torch.Tensor, p: DeviceParams) -> torch.Tensor:
    g = conductance(m, p)
    return const(1.0, g) / g


def tmr_ratio(p: DeviceParams) -> float:
    """(R_AP - R_P)/R_P as modeled — equals ``p.tmr`` by construction."""
    return (p.r_antiparallel - p.r_parallel) / p.r_parallel


def read_margin(p: DeviceParams, v_read: float = 0.1) -> float:
    """Sense current differential Delta_I = V (G_P - G_AP) at read voltage."""
    return v_read * (1.0 / p.r_parallel - 1.0 / p.r_antiparallel)
