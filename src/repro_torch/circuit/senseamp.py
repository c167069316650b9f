"""Latch-type sense amplifier behavioral model (port of
``repro.circuit.senseamp``, deterministic mode).

Delay follows the latch regeneration law
t_sa = tau_latch ln(V_logic / |dV_in|) + t_setup; dual references implement
XOR/XNOR, single references (N)AND / (N)OR / MAJ.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.circuit.bitline import (BitlineParams, logic_current_levels,
                                         multi_row_current)
from repro_torch.core.params import DeviceParams


@dataclasses.dataclass(frozen=True)
class SenseAmpParams:
    tau_latch: float = 20e-12     # regeneration time constant [s]
    t_setup: float = 20e-12       # precharge/strobe overhead [s]
    v_logic: float = 1.0          # full-swing output [V]
    r_trans: float = 5.0e3        # current->voltage transimpedance [Ohm]
    e_per_sense: float = 2.0e-15  # energy per sense operation [J]


def sense_delay(di: torch.Tensor, sa: SenseAmpParams) -> torch.Tensor:
    """Sense time for a current differential di [A] from the reference."""
    dv = torch.abs(di) * sa.r_trans
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
                  bl: BitlineParams, sa: SenseAmpParams
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-array logic on ``bits`` (..., n_rows) through the analog bit-line
    current and the sense-amp thresholds: (boolean output, sense delay)."""
    n_rows = bits.shape[-1]
    i_bl = multi_row_current(bits, dev, bl)
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
