"""Latch-type sense amplifier behavioral model (port of
``repro.circuit.senseamp``).

Delay follows the latch regeneration law
t_sa = tau_latch ln(V_logic / |dV_in|) + t_setup; dual references implement
XOR/XNOR, single references (N)AND / (N)OR / MAJ.

Monte-Carlo mode (DESIGN.md §10): a latch has an input-referred offset
~N(0, ``offset_sigma``).  ``sa_offsets`` draws one per lane from the
counter-RNG of ``kernels.noise`` (salted by the seed only, so sweeps reuse
one mismatch population); ``sense_delay`` and ``resolve_logic`` take it as
``offset``.  ``offset=None`` and ``offset_sigma = 0`` are bit-identical to
the deterministic path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.circuit.bitline import (BitlineParams, logic_current_levels,
                                         multi_row_current)
from repro_torch.core.params import DeviceParams
from repro_torch.kernels import noise


@dataclasses.dataclass(frozen=True)
class SenseAmpParams:
    tau_latch: float = 20e-12     # regeneration time constant [s]
    t_setup: float = 20e-12       # precharge/strobe overhead [s]
    v_logic: float = 1.0          # full-swing output [V]
    r_trans: float = 5.0e3        # current->voltage transimpedance [Ohm]
    e_per_sense: float = 2.0e-15  # energy per sense operation [J]
    offset_sigma: float = 0.0     # input-referred offset std [V] (MC mode)


# seed salt of the offset draws: a stream of its own, apart from the
# thermal-field counters
_OFFSET_STREAM = 0x5A0FF5E7


def sa_offsets(sa: SenseAmpParams, n: int, seed: int = 0,
               device=None) -> torch.Tensor:
    """(n,) float32 input-referred offsets [V] ~ N(0, offset_sigma): the
    counter-RNG's normals of lanes 0..n-1 of the stream ``seed ^
    0x5A0FF5E7``; exact zeros at ``offset_sigma == 0``."""
    if sa.offset_sigma == 0.0:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    lanes = noise.as_uint32(noise.cell_seeds(seed ^ _OFFSET_STREAM, n,
                                             device))
    z, _ = noise.normal_pair(lanes, 0)
    return (sa.offset_sigma * z).to(torch.float32)


def sense_delay(di: torch.Tensor, sa: SenseAmpParams,
                offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sense time for a current differential di [A] from the reference.
    ``offset`` [V] (broadcast against ``di``) shifts the latch input:
    |di r + offset|; ``offset=None`` is |di| r, which equals a zero offset
    exactly."""
    if offset is None:
        dv = torch.abs(di) * sa.r_trans
    else:
        dv = torch.abs(di * sa.r_trans + offset)
    dv = torch.clamp(dv, min=1e-6)
    v_logic = torch.tensor(sa.v_logic, dtype=dv.dtype, device=dv.device)
    return sa.tau_latch * torch.log(v_logic / torch.clamp(dv, max=sa.v_logic)) \
        + sa.t_setup


def _refs_for(op: str, n_rows: int, dev: DeviceParams, bl: BitlineParams,
              device):
    """Reference current(s) placed between the k-parallel-cell levels."""
    lv = logic_current_levels(n_rows, dev, bl, device)

    def mid(a, b):
        return 0.5 * (lv[a] + lv[b])

    if op in ("and", "nand"):       # true when ALL k bits are 1
        return (mid(n_rows - 1, n_rows),)
    if op in ("or", "nor"):         # true when ANY bit is 1
        return (mid(0, 1),)
    if op in ("xor", "xnor"):       # true when exactly one of two bits is 1
        assert n_rows == 2, "xor/xnor uses 2-row activation"
        return (mid(0, 1), mid(1, 2))
    if op == "maj":                 # majority of 3
        assert n_rows == 3
        return (mid(1, 2),)
    raise ValueError(f"unknown logic op {op}")


def resolve_logic(bits: torch.Tensor, op: str, dev: DeviceParams,
                  bl: BitlineParams, sa: SenseAmpParams,
                  offset: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-array logic on ``bits`` (..., n_rows) through the analog bit-line
    current and the sense-amp thresholds: (boolean output, sense delay).
    ``offset`` [V] (``sa_offsets``), referred to the current domain through
    ``r_trans``, is added before the threshold, so a large one flips the
    decision; ``offset=None`` is the deterministic path."""
    n_rows = bits.shape[-1]
    i_bl = multi_row_current(bits, dev, bl)
    if offset is not None:
        i_bl = i_bl + offset / sa.r_trans
    refs = _refs_for(op, n_rows, dev, bl, bits.device)
    if op in ("and", "or", "maj"):
        out = i_bl > refs[0]
        di = i_bl - refs[0]
    elif op in ("nand", "nor"):
        out = i_bl < refs[0]
        di = i_bl - refs[0]
    elif op == "xor":
        out = (i_bl > refs[0]) & (i_bl < refs[1])
        di = torch.minimum(torch.abs(i_bl - refs[0]), torch.abs(i_bl - refs[1]))
    elif op == "xnor":
        out = (i_bl < refs[0]) | (i_bl > refs[1])
        di = torch.minimum(torch.abs(i_bl - refs[0]), torch.abs(i_bl - refs[1]))
    else:
        raise ValueError(op)
    return out, sense_delay(di, sa)
