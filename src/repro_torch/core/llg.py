"""Dual-sublattice Landau-Lifshitz-Gilbert dynamics (paper Sec. II).

Port of ``repro.core.llg``.  State convention: ``m`` has shape
``(..., n_sub, 3)`` — unit magnetization vectors per sublattice (2 for the
AFMTJ, 1 for the MTJ), float32, on any device.  The implicit Gilbert form
is solved exactly:

    dm/dt = (T + alpha m x T) / (1 + alpha^2),

with T the explicit torques (precession, staggered Neel STT, field-like);
the inter-sublattice exchange enters the effective field as
B_ex,i = -B_E m_j.

Every operation below is one float32 elementwise op in the order the
reference evaluates it, so the CPU results agree with the reference to
rounding.  Python-float parameters are rounded to float32 where they meet a
tensor, exactly as the reference's jit does with static parameters.  They
enter as cached float32 tensors on the operand's device (``const``): that
saves the per-operation scalar conversion in the step loops, and a division
by a Python scalar on the GPU would become a multiplication by its
reciprocal, which rounds differently.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.params import GAMMA, DeviceParams

Scalar = Union[float, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _const_cached(value: float, device: str) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def const(value: Scalar, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device (tensors pass
    through).  Cached, so hot loops pay no host-to-device copy."""
    if isinstance(value, torch.Tensor):
        return value
    return _const_cached(float(value), str(like.device))


def stt_signs(p: DeviceParams) -> tuple:
    """Per-sublattice STT polarization sign (staggered for the AFMTJ)."""
    return (1.0,) if p.n_sublattices == 1 else (1.0, -1.0)


@functools.lru_cache(maxsize=None)
def _rows(rows: tuple, device: str) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _p_axis_rolled(p: DeviceParams, like: torch.Tensor):
    """The (n_sub, 3) polarization directions s_i z_hat as the reference
    builds them (``stt_signs * P_AXIS``; the second AFMTJ row is
    (-0, -0, -1)), rolled left and right for the cross product."""
    rows = tuple((0.0 * s, 0.0 * s, s) for s in stt_signs(p))
    left = tuple((r[1], r[2], r[0]) for r in rows)
    right = tuple((r[2], r[0], r[1]) for r in rows)
    dev = str(like.device)
    return _rows(left, dev), _rows(right, dev)


@functools.lru_cache(maxsize=None)
def _perm(order: tuple, device: str) -> torch.Tensor:
    return torch.tensor(order, dtype=torch.int64, device=device)


def _roll_l(x: torch.Tensor) -> torch.Tensor:   # (x1, x2, x0)
    return torch.index_select(x, -1, _perm((1, 2, 0), str(x.device)))


def _roll_r(x: torch.Tensor) -> torch.Tensor:   # (x2, x0, x1)
    return torch.index_select(x, -1, _perm((2, 0, 1), str(x.device)))


def effective_field(m: torch.Tensor, p: DeviceParams,
                    b_thermal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B_eff per sublattice: anisotropy B_k m_z z_hat + exchange -B_E m_other
    (+ thermal).  ``p.b_aniso`` may be a per-lane ``(cells, 1, 1)`` tensor.
    The x/y anisotropy components are exact zeros, as in the reference."""
    b_ex = const(-p.b_exchange, m) * torch.flip(m, dims=(-2,))
    ez = _rows((0.0, 0.0, 1.0), str(m.device))
    b = (const(p.b_aniso, m) * m[..., 2:3]) * ez + b_ex
    if b_thermal is not None:
        b = b + b_thermal
    return b


def llg_rhs(m: torch.Tensor, p: DeviceParams, a_j: torch.Tensor,
            b_thermal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dm/dt for every sublattice.  ``a_j``: damping-like STT magnitude [T],
    shape ``m.shape[:-2]`` (sign = current direction).  ``p.alpha`` and
    ``p.b_aniso`` may be per-lane ``(cells, 1, 1)`` tensors (the variation
    rows of the campaign kernel)."""
    b = effective_field(m, p, b_thermal)
    a_j = a_j[..., None, None]
    m_l, m_r = _roll_l(m), _roll_r(m)

    def mcross(x):
        # m x x with jnp.cross's component formula (m1 x2 - m2 x1,
        # m2 x0 - m0 x2, m0 x1 - m1 x0), written with rolled vectors
        return m_l * _roll_r(x) - m_r * _roll_l(x)

    p_l, p_r = _p_axis_rolled(p, m)
    mxp = m_l * p_r - m_r * p_l                       # m x p
    neg_gamma = const(-GAMMA, m)
    t_prec = neg_gamma * mcross(b)
    t_stt = const(GAMMA, m) * a_j * mcross(mxp)
    t_flt = neg_gamma * (const(p.beta_flt, m) * a_j) * mxp
    t = t_prec + t_stt + t_flt
    if isinstance(p.alpha, torch.Tensor):
        denom = 1.0 + p.alpha * p.alpha
    else:
        denom = const(1.0 + p.alpha ** 2, m)
    return (t + const(p.alpha, m) * mcross(t)) / denom


def neel_vector(m: torch.Tensor) -> torch.Tensor:
    """Neel (staggered) vector n = (m1 - m2)/2 for the AFMTJ; m for the MTJ."""
    if m.shape[-2] == 1:
        return m[..., 0, :]
    return 0.5 * (m[..., 0, :] - m[..., 1, :])


def net_moment(m: torch.Tensor) -> torch.Tensor:
    """Net magnetization (m1 + m2)/2 — near zero for a compensated AFM."""
    return torch.mean(m, dim=-2)


def order_parameter_z(m: torch.Tensor) -> torch.Tensor:
    """z-component of the order parameter used for switching detection."""
    if m.shape[-2] == 1:
        return m[..., 0, 2]
    return 0.5 * (m[..., 0, 2] - m[..., 1, 2])


def initial_state(p: DeviceParams, theta0: Scalar = 0.0, phi0: Scalar = 0.0,
                  up: bool = True, device=None) -> torch.Tensor:
    """Equilibrium-ish initial state tilted by ``theta0`` from the easy axis.

    ``theta0``/``phi0`` may be float32 tensors of one batch shape; the
    result is ``(*batch, n_sub, 3)``.  AFMTJ: sublattice 2 exactly
    antiparallel (``m2 = -m1``).  Python-float angles are placed on
    ``device`` (``None`` means CUDA, see ``resolve_device``).
    """
    if isinstance(theta0, torch.Tensor):
        dev = theta0.device
    elif isinstance(phi0, torch.Tensor):
        dev = phi0.device
    else:
        dev = resolve_device(device)
    th = torch.as_tensor(theta0, dtype=torch.float32, device=dev)
    ph = torch.as_tensor(phi0, dtype=torch.float32, device=dev)
    s = 1.0 if up else -1.0
    st = torch.sin(th)
    th, ph, st = torch.broadcast_tensors(th, ph, st)
    m1 = torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                      s * torch.cos(th)], dim=-1)
    if p.n_sublattices == 1:
        return m1[..., None, :]
    return torch.stack([m1, -m1], dim=-2)


def renormalize(m: torch.Tensor) -> torch.Tensor:
    """Project back to |m| = 1 (RK integrators drift at O(h^5)).  Divides
    by the norm, as the reference's ``renormalize`` does."""
    sq = m * m
    norm = torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3])
    return m / norm
