"""Junction-level operations: write / read (paper Sec. III-B, Fig. 3).

Port of ``repro.core.device`` for the deterministic write
(``thermal_sigma = 0``).  ``simulate_write``
integrates the coupled transport + dynamics system: the instantaneous
conductance G(theta(t)) sets the current density, which sets the STT
amplitude a_J(t).  Switching time is the first crossing of the order
parameter below -0.9; write latency adds the bit-line RC settle time;
energy is the integral of V^2 G dt over the pulse.  ``write_sweep`` runs
every voltage of a sweep as one lane of one integration (paper Fig. 3).
``variation`` is one sampled device of a process corner
(``VariationSpec.sample_device``, DESIGN.md §9): its parameters replace
``p``, its conductance factor scales the drive and every conductance of the
energy, and the default tilt comes from its volume-adjusted Delta; at the
nominal corner every factor is exactly 1.0 and the result is bit-identical
to ``variation=None``.

The write loop is ``kernels.llg_write.llg_write_kernel``: the CUDA kernel
``csrc/llg_write.cu`` for CUDA tensors, its plain version
``kernels.ref.ref_llg_write`` (time accumulated as ``t = t + dt`` in
float32, the crossing stamped ``t + dt``, as in the reference's scan) for
CPU tensors.  The pulse tail, RC overhead and latency are the same
PyTorch operations on either device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import llg, tmr
from repro_torch.core.integrator import BASE_DT
from repro_torch.core.params import DeviceParams, DeviceSample


def thermal_theta0(p: DeviceParams, delta: Optional[float] = None) -> float:
    """Equilibrium Boltzmann tilt theta_0 = sqrt(1/(2 Delta)) of ``p`` (or
    of the barrier ``delta``), evaluated in float32 as the reference does
    (max, scale, reciprocal and sqrt are all correctly rounded, so the
    value is bit-identical)."""
    d = p.thermal_stability if delta is None else delta
    d = np.maximum(np.float32(d), np.float32(1.0))
    return float(np.sqrt(np.float32(1.0) / (np.float32(2.0) * d)))


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
    variation: Optional[DeviceSample] = None,
    device=None,
) -> WriteResult:
    """Write (P -> AP: order parameter +z -> -z) at ``voltage``, with the
    STT amplitude re-evaluated from the conductance at every step."""
    r = write_sweep(p, [float(voltage)], n_steps=n_steps, dt=dt,
                    theta0=theta0, t_rc=t_rc, pulse_margin=pulse_margin,
                    down=down, variation=variation, device=device)
    return WriteResult(*(getattr(r, f.name)[0]
                         for f in dataclasses.fields(WriteResult)))


def write_sweep(
    p: DeviceParams,
    voltages,
    n_steps: int = 30000,
    dt: float = BASE_DT,
    theta0: Optional[float] = None,
    t_rc: float = 40e-12,
    pulse_margin: float = 1.02,
    down: bool = True,
    variation: Optional[DeviceSample] = None,
    device=None,
) -> WriteResult:
    """Voltage sweep (paper Fig. 3): one write per voltage, all in one
    integration (one kernel launch on the card); every field of the
    result has a leading voltage axis.  ``variation`` writes one sampled
    device at every voltage (see the module docstring)."""
    from repro_torch.kernels.llg_write import llg_write_kernel

    dev = resolve_device(device)
    v = torch.as_tensor(voltages, dtype=torch.float32).reshape(-1).to(dev)
    g_scale = 1.0
    if variation is not None:
        p = variation.params
        g_scale = variation.g_scale
        if theta0 is None:
            theta0 = thermal_theta0(p, variation.thermal_stability)
    th0 = thermal_theta0(p) if theta0 is None else theta0
    m0 = llg.initial_state(p, theta0=th0, phi0=0.3, up=down, device=dev)
    m0 = m0.expand(v.shape[0], *m0.shape).contiguous()
    gs = (None if variation is None else
          torch.full(v.shape, g_scale, dtype=torch.float32, device=dev))
    m, t_sw, sw, en = llg_write_kernel(m0, v, p, dt, n_steps, down, gs)

    # write pulse = switching time * margin; energy already integrated up to
    # the switch, add the margin tail at the post-switch conductance and the
    # RC/driver overhead at the initial (parallel-state) conductance, each
    # scaled by the sampled device's conductance factor (1.0: exact)
    v2 = v * v
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    g_final = tmr.conductance(m, p) * g_scale
    tail = (pulse_margin - 1.0) * t_sw
    tail = torch.where(torch.isfinite(tail), tail, zero)
    g0 = tmr.conductance(m0, p) * g_scale
    energy = en + v2 * g_final * tail + v2 * g0 * t_rc
    latency = t_sw * pulse_margin + t_rc
    return WriteResult(t_switch=t_sw, write_latency=latency, energy=energy,
                       switched=sw, final_state=m)


def simulate_read(p: DeviceParams, m: torch.Tensor, v_read: float = 0.1):
    """Read op: sense current at ``v_read``; returns (current, resistance)."""
    g = tmr.conductance(m, p)
    return llg.const(v_read, g) * g, llg.const(1.0, g) / g


def read_energy(p: DeviceParams, t_read: float = 1e-9, v_read: float = 0.1) -> float:
    """Worst-case (parallel-state) read energy."""
    return v_read**2 / p.r_parallel * t_read
