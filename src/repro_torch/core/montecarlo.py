"""Thermal Monte-Carlo ensembles: Brown's thermal field and the write-error
rate (port of ``repro.core.montecarlo``).

Per-component std  sigma_B = sqrt(2 alpha k_B T / (gamma Ms V dt))  [T].

``write_error_rate`` is a single-point campaign through the campaign
engine: the whole thermal ensemble is one launch of the LLG kernel with
its in-kernel counter-RNG noise.  ``write_error_rate_scan`` is the
independent baseline, a per-step loop in plain PyTorch over the port's
``core.llg`` / ``core.integrator`` with its own draws (``scan_draws``: the
tilt, the phase and every step's Brown-field normals), the statistical
cross-check the engine is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core import llg
from repro_torch.core.device import a_j_from_voltage, thermal_theta0
from repro_torch.core.integrator import rk4_step
from repro_torch.core.params import GAMMA, KB, DeviceParams


def thermal_sigma(p: DeviceParams, dt: float) -> float:
    return math.sqrt(
        2.0 * p.alpha * KB * p.temperature / (GAMMA * p.ms * p.volume * dt))


def write_error_rate(p: DeviceParams, voltage: float, pulse_s: float,
                     n_samples: int = 64, dt: float = 0.1e-12,
                     n_steps: Optional[int] = None, seed: int = 0,
                     use_cache: bool = False, device=None) -> float:
    """Fraction of thermal samples not switched by the end of the pulse: a
    single-point (V, pulse, T) grid through ``run_campaign`` (one launch
    of the LLG kernel on the card), read off its WER surface."""
    # campaign builds on core: imported here, not at module scope
    from repro_torch.campaign.engine import run_campaign
    from repro_torch.campaign.grid import CampaignGrid

    pulse = float(pulse_s if n_steps is None else n_steps * dt)
    grid = CampaignGrid(voltages=(float(voltage),), pulse_widths=(pulse,),
                        temperatures=(p.temperature,), n_samples=n_samples,
                        dt=dt, seed=seed)
    res = run_campaign(p, grid, use_cache=use_cache, device=device)
    return float(res.wer_surface()[0, 0, 0])


def scan_draws(seed: int, n_samples: int, n_steps: int, n_sub: int):
    """(z, phase, normals) of the scan baseline: per sample a standard
    normal for the tilt and a phase uniform in [0, 2 pi), and per step and
    sample an (n_sub, 3) standard-normal Brown-field draw — float32 on the
    CPU from a ``torch.Generator`` seeded with ``seed``.  The reference
    draws these with ``jax.random``; the tests hand its draws over by
    replacing this function."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    z = torch.randn(n_samples, generator=gen)
    phase = torch.rand(n_samples, generator=gen) * (2 * math.pi)
    normals = torch.randn((n_steps, n_samples, n_sub, 3), generator=gen)
    return z, phase, normals


def scan_switched(p: DeviceParams, voltage: float, pulse_s: float,
                  n_samples: int = 64, dt: float = 0.1e-12,
                  n_steps: Optional[int] = None, seed: int = 0,
                  device=None) -> torch.Tensor:
    """(n_samples,) bool: which samples of the scan baseline switched.  All
    samples step together: the STT drive from the state at the start of
    the step, RK4 with that step's Brown field, and a sample counts as
    switched once its order parameter passes -0.9 at any step."""
    dev = resolve_device(device)
    n_steps = int(pulse_s / dt) if n_steps is None else n_steps
    z, phase, normals = scan_draws(seed, n_samples, n_steps, p.n_sublattices)
    z, phase, normals = z.to(dev), phase.to(dev), normals.to(dev)
    th = torch.abs(z) * llg.const(thermal_theta0(p), z) + llg.const(0.01, z)
    m = llg.initial_state(p, th, phase)
    sigma = llg.const(thermal_sigma(p, dt), m)
    v = llg.const(float(voltage), m)
    switched = torch.zeros(n_samples, dtype=torch.bool, device=dev)
    for i in range(n_steps):
        aj = a_j_from_voltage(v, m, p)
        b_th = sigma * normals[i]
        m = rk4_step(lambda mm, tt: llg.llg_rhs(mm, p, aj, b_th), m, 0.0, dt)
        switched |= llg.order_parameter_z(m) < -0.9
    return switched


def write_error_rate_scan(p: DeviceParams, voltage: float, pulse_s: float,
                          n_samples: int = 64, dt: float = 0.1e-12,
                          n_steps: Optional[int] = None, seed: int = 0,
                          device=None) -> float:
    """The scan baseline's WER: 1 - the switched fraction of
    ``scan_switched``, an independently drawn estimate of what
    ``write_error_rate`` measures."""
    sw = scan_switched(p, voltage, pulse_s, n_samples, dt, n_steps, seed,
                       device)
    return float(1.0 - torch.mean(sw.to(torch.float32)))
