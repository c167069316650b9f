"""Fixed-step RK4 for the LLG system (paper: RK4, 0.1 ps base step).

Port of ``repro.core.integrator.rk4_step``: the one step every path of the
port takes (single-junction writes, the plain campaign integrator and, in
CUDA, the kernel).  The state is renormalized after every step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.llg import const, renormalize

BASE_DT = 0.1e-12  # 0.1 ps (paper)

RHS = Callable[[torch.Tensor, float], torch.Tensor]   # (m, t) -> dm/dt


def rk4_step(rhs: RHS, m: torch.Tensor, t: float, dt: float) -> torch.Tensor:
    half, full, sixth = const(0.5 * dt, m), const(dt, m), const(dt / 6.0, m)
    two = const(2.0, m)
    k1 = rhs(m, t)
    k2 = rhs(m + half * k1, t + 0.5 * dt)
    k3 = rhs(m + half * k2, t + 0.5 * dt)
    k4 = rhs(m + full * k3, t + dt)
    return renormalize(m + sixth * (k1 + two * k2 + two * k3 + k4))
