"""Brown's thermal field for the Monte-Carlo ensembles.

Per-component std  sigma_B = sqrt(2 alpha k_B T / (gamma Ms V dt))  [T],
the formula of ``repro.core.montecarlo.thermal_sigma``.
"""
from __future__ import annotations

import math

from repro_torch.core.params import GAMMA, KB, DeviceParams


def thermal_sigma(p: DeviceParams, dt: float) -> float:
    return math.sqrt(
        2.0 * p.alpha * KB * p.temperature / (GAMMA * p.ms * p.volume * dt))
