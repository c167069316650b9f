"""Junction-level operations: write / read (paper Sec. III-B, Fig. 3).

Port of ``repro.core.device`` for the deterministic write
(``thermal_sigma = 0``, no process variation).  ``simulate_write``
integrates the coupled transport + dynamics system: the instantaneous
conductance G(theta(t)) sets the current density, which sets the STT
amplitude a_J(t).  Switching time is the first crossing of the order
parameter below -0.9; write latency adds the bit-line RC settle time;
energy is the integral of V^2 G dt over the pulse.

The integration is one junction stepped by plain PyTorch on the chosen
device, one RK4 step per loop iteration with no host synchronisation.  Time
accumulates as ``t = t + dt`` in float32 and the crossing is stamped
``t + dt``, as in the reference's scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import llg, tmr
from repro_torch.core.integrator import BASE_DT, rk4_step
from repro_torch.core.params import DeviceParams


def thermal_theta0(p: DeviceParams) -> float:
    """Equilibrium Boltzmann tilt theta_0 = sqrt(1/(2 Delta)), evaluated in
    float32 as the reference does (max, scale, reciprocal and sqrt are all
    correctly rounded, so the value is bit-identical)."""
    delta = np.maximum(np.float32(p.thermal_stability), np.float32(1.0))
    return float(np.sqrt(np.float32(1.0) / (np.float32(2.0) * delta)))


@dataclasses.dataclass(frozen=True)
class WriteResult:
    t_switch: torch.Tensor       # intrinsic magnetization reversal time [s]
    write_latency: torch.Tensor  # t_switch * margin + t_rc  [s]
    energy: torch.Tensor         # dynamic write energy [J]
    switched: torch.Tensor       # bool
    final_state: torch.Tensor


def a_j_from_voltage(v, m: torch.Tensor, p: DeviceParams) -> torch.Tensor:
    """Self-consistent STT amplitude [T]: a_J = pref * V G(m) / A."""
    g = tmr.conductance(m, p)
    j_density = v * g / llg.const(p.area, g)
    return p.stt_prefactor * j_density


def simulate_write(
    p: DeviceParams,
    voltage: float,
    n_steps: int = 30000,
    dt: float = BASE_DT,
    theta0: Optional[float] = None,
    t_rc: float = 40e-12,
    pulse_margin: float = 1.02,
    down: bool = True,
    device=None,
) -> WriteResult:
    """Write (P -> AP: order parameter +z -> -z) at ``voltage``, with the
    STT amplitude re-evaluated from the conductance at every step."""
    dev = resolve_device(device)
    f32 = torch.float32
    th0 = thermal_theta0(p) if theta0 is None else theta0
    m0 = llg.initial_state(p, theta0=th0, phi0=0.3, up=down, device=dev)
    v = torch.tensor(float(voltage), dtype=f32, device=dev)
    v2 = v * v
    dt_t = torch.tensor(dt, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    m = m0
    t = torch.zeros((), dtype=f32, device=dev)
    t_sw = torch.full((), float("inf"), dtype=f32, device=dev)
    sw = torch.zeros((), dtype=torch.bool, device=dev)
    en = torch.zeros((), dtype=f32, device=dev)
    for _ in range(int(n_steps)):
        a_j = a_j_from_voltage(v, m, p)
        m = rk4_step(lambda mm, tt: llg.llg_rhs(mm, p, a_j), m, 0.0, dt)
        opz = llg.order_parameter_z(m)
        crossed = opz < -0.9 if down else opz > 0.9
        t_next = t + dt_t
        t_sw = torch.where(crossed & ~sw, t_next, t_sw)
        sw = sw | crossed
        g = tmr.conductance(m, p)
        en = en + torch.where(sw, zero, v2 * g * dt_t)
        t = t_next

    # write pulse = switching time * margin; energy already integrated up to
    # the switch, add the margin tail at the post-switch conductance and the
    # RC/driver overhead at the initial (parallel-state) conductance
    g_final = tmr.conductance(m, p)
    tail = (pulse_margin - 1.0) * t_sw
    tail = torch.where(torch.isfinite(tail), tail, zero)
    g0 = tmr.conductance(m0, p)
    energy = en + v2 * g_final * tail + v2 * g0 * t_rc
    latency = t_sw * pulse_margin + t_rc
    return WriteResult(t_switch=t_sw, write_latency=latency, energy=energy,
                       switched=sw, final_state=m)


def read_energy(p: DeviceParams, t_read: float = 1e-9, v_read: float = 0.1) -> float:
    """Worst-case (parallel-state) read energy."""
    return v_read**2 / p.r_parallel * t_read
