"""RK4 integrators for the LLG system (paper: RK4, 0.1 ps base step).

Port of ``repro.core.integrator``:

* ``rk4_step`` — the one step every path of the port takes (single-junction
  writes, the plain campaign integrator and, in CUDA, the kernels);
* ``integrate_fixed`` — fixed-step RK4 over a per-step a_J series, with
  first-crossing and energy observables (``Trace``);
* ``integrate_adaptive`` — step-doubling adaptive RK4 (the paper's
  "adaptive fourth-order Runge-Kutta, 0.1 ps base step"), used to check
  that 0.1 ps fixed stepping is converged.

Both integrators are plain PyTorch on the caller's device; no kernel backs
them (the reference runs them as ``lax.scan`` / ``lax.while_loop``).  The
state is renormalized after every step.  The reference draws the thermal
field of ``integrate_fixed`` with ``jax.random``; the port takes the
standard normals as an explicit ``(n_steps, *m0.shape)`` tensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.llg import const, llg_rhs, order_parameter_z, renormalize
from repro_torch.core.params import DeviceParams

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


class Trace(NamedTuple):
    """Per-step observables accumulated during integration."""

    t_switch: torch.Tensor     # first time order parameter crossed -thresh [s]
    switched: torch.Tensor     # bool
    energy: torch.Tensor       # integral of V^2 * G(theta) dt  [J]
    final_m: torch.Tensor      # state at t_end


def integrate_fixed(
    m0: torch.Tensor,
    p: DeviceParams,
    a_j_of_t,                     # (n_steps,) or scalar: STT field vs time [T]
    dt: float = BASE_DT,
    n_steps: int = 2000,
    conductance_fn=None,          # optional: (m) -> G [S], for energy integral
    voltage: float = 0.0,
    switch_threshold: float = 0.9,
    record_trajectory: bool = False,
    thermal_sigma: float = 0.0,
    normals: Optional[torch.Tensor] = None,
) -> Tuple[Trace, Optional[torch.Tensor]]:
    """Fixed-step RK4 for ``n_steps``; broadcasts over leading dims of
    ``m0``.  With ``thermal_sigma > 0`` the Brown field of step i is
    ``thermal_sigma * normals[i]``, held constant over the RK4 stages:
    ``normals`` is the caller's ``(n_steps, *m0.shape)`` tensor of standard
    normals (e.g. ``torch.randn(..., generator=g)``).
    Returns ``(Trace, trajectory)``, the trajectory ``(n_steps, *m0.shape)``
    when ``record_trajectory``, else None."""
    f32 = torch.float32
    dev = m0.device
    batch_shape = m0.shape[:-2]
    a_j = torch.broadcast_to(torch.as_tensor(a_j_of_t, dtype=f32, device=dev),
                             (n_steps,))
    if thermal_sigma > 0.0:
        if normals is None or tuple(normals.shape) != (n_steps, *m0.shape):
            got = None if normals is None else tuple(normals.shape)
            raise ValueError(f"the thermal path needs normals of shape "
                             f"{(n_steps, *m0.shape)}, got {got}")
        sigma = const(thermal_sigma, m0)
    dt_t = const(dt, m0)
    v2 = const(voltage, m0) * const(voltage, m0)
    neg_thr = -switch_threshold
    zero = torch.zeros((), dtype=f32, device=dev)

    m = m0
    t = torch.zeros((), dtype=f32, device=dev)
    t_sw = torch.full(batch_shape, float("inf"), dtype=f32, device=dev)
    sw = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    en = torch.zeros(batch_shape, dtype=f32, device=dev)
    traj = []
    for i in range(int(n_steps)):
        b_th = sigma * normals[i] if thermal_sigma > 0.0 else None
        m = rk4_step(lambda mm, tt: llg_rhs(mm, p, a_j[i], b_th), m, 0.0, dt)
        crossed = order_parameter_z(m) < neg_thr
        t_next = t + dt_t
        t_sw = torch.where(crossed & ~sw, t_next, t_sw)
        sw = sw | crossed
        if conductance_fn is not None:
            en = en + torch.where(sw, zero, v2 * conductance_fn(m) * dt_t)
        t = t_next
        if record_trajectory:
            traj.append(m)
    trace = Trace(t_switch=t_sw, switched=sw, energy=en, final_m=m)
    return trace, (torch.stack(traj) if record_trajectory else None)


def integrate_adaptive(
    m0: torch.Tensor,
    p: DeviceParams,
    a_j,
    t_end: float,
    dt0: float = BASE_DT,
    rtol: float = 1e-6,
    dt_min: float = 1e-15,
    dt_max: float = 2e-12,
    switch_threshold: float = 0.9,
) -> Trace:
    """Step-doubling adaptive RK4 (single junction; constant drive).

    Error estimate: one full step vs two half steps; local error ~
    |y2 - y1|/15; a step is accepted when err < rtol, and the next step is
    h * clip(0.9 (rtol/err)^(1/5), 0.2, 5), clipped to [dt_min, dt_max].
    The loop tests ``t < t_end`` on the host once per step."""
    f32 = torch.float32
    a_j = torch.as_tensor(a_j, dtype=f32, device=m0.device)

    def rhs(m, t):
        return llg_rhs(m, p, a_j)

    c = lambda x: const(x, m0)   # noqa: E731
    m = m0
    t = torch.zeros((), dtype=f32, device=m0.device)
    h = c(dt0)
    t_sw = torch.full((), float("inf"), dtype=f32, device=m0.device)
    sw = torch.zeros((), dtype=torch.bool, device=m0.device)
    while bool(t < c(t_end)):
        h = torch.minimum(h, c(t_end) - t)
        half = c(0.5) * h
        y1 = rk4_step(rhs, m, t, h)
        yh = rk4_step(rhs, m, t, half)
        y2 = rk4_step(rhs, yh, t + half, half)
        err = torch.max(torch.abs(y2 - y1)) / c(15.0)
        accept = err < c(rtol)
        scale = c(0.9) * torch.pow(c(rtol) / torch.maximum(err, c(1e-30)),
                                   c(0.2))
        h_new = torch.clamp(h * torch.clamp(scale, c(0.2), c(5.0)),
                            c(dt_min), c(dt_max))
        m = torch.where(accept, y2, m)
        t = torch.where(accept, t + h, t)
        crossed = accept & (order_parameter_z(m) < -switch_threshold)
        t_sw = torch.where(crossed & ~sw, t, t_sw)
        sw = sw | crossed
        h = h_new
    return Trace(t_switch=t_sw, switched=sw,
                 energy=torch.zeros((), dtype=f32, device=m0.device),
                 final_m=m)
