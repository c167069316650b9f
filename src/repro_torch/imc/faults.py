"""Hard-fault injection for AFMTJ crossbars: stuck-at cells, dead lines,
endurance wear-out and the repair policies that contain them (port of
``repro.imc.faults``, DESIGN.md §13).

Every defect plane comes from the counter-RNG of ``kernels.noise`` — a draw
depends only on (seed, stream, lane), never on the rate or the repair
policy — so the planes are the reference's bit for bit.  uint32 arithmetic
runs on int64 tensors masked with ``& 0xFFFFFFFF``, as in ``kernels.noise``.
Fault codes are bit-ORs (``kernels.fake_analog.FAULT_*``) riding the fail
plane of the fused kernel; dead columns ride the aux attenuation rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import noise
from repro_torch.kernels.fake_analog import (
    FAULT_DEAD,
    FAULT_NEG_OFF,
    FAULT_NEG_ON,
    FAULT_POS_OFF,
    FAULT_POS_ON,
    fail_bit,
)

# stream ids of the per-lane uniform draws (disjoint by construction)
_STREAM_POS = 0      # positive-cell defect class
_STREAM_NEG = 1      # negative-cell defect class
_STREAM_ROW = 2      # dead row drivers
_STREAM_COL = 3      # dead column drivers
_STREAM_DRIFT_P = 4  # conductance drift, positive array (device path)
_STREAM_DRIFT_N = 5  # conductance drift, negative array (device path)

_MASK = 0xFFFFFFFF
_FAULT_GOLD = 0x9E3779B1
_FAULT_STREAM = 0xC2B2AE35


def _lane_seeds(seed, stream: int, count: int, device=None) -> torch.Tensor:
    """(count,) uint32 stream seeds as int64 values: ``noise.cell_seeds``
    salted like ``VariationSpec._normals``."""
    base = ((int(seed) & _MASK) * _FAULT_GOLD
            + (((stream + 1) * _FAULT_STREAM) & _MASK)) & _MASK
    idx = torch.arange(count, dtype=torch.int64, device=device)
    return noise.mix32(noise.mix32((base + idx * 0x9E3779B9) & _MASK))


def _lane_uniforms(seed, stream: int, count: int, device=None) -> torch.Tensor:
    """(count,) float32 uniforms in (0, 1]: ``u <= rate`` at rate 0 is never
    true, so a zero-rate plane is exactly the empty defect map."""
    return noise._uniform24(_lane_seeds(seed, stream, count, device))


def fault_code_plane(rows: int, cols: int, *, seed, stuck_on, stuck_off,
                     dead_row, device=None) -> torch.Tensor:
    """(rows, cols) float32 bit-code defect plane.  One uniform per cell is
    split into disjoint [0, p_off] stuck-off and (p_off, p_off + p_on]
    stuck-on intervals (rates compared in float32, as the reference)."""
    f32 = torch.float32
    p_off = torch.tensor(float(stuck_off), dtype=f32, device=device)
    p_on = torch.tensor(float(stuck_on), dtype=f32, device=device)
    u_pos = _lane_uniforms(seed, _STREAM_POS, rows * cols, device).reshape(rows, cols)
    u_neg = _lane_uniforms(seed, _STREAM_NEG, rows * cols, device).reshape(rows, cols)
    u_row = _lane_uniforms(seed, _STREAM_ROW, rows, device)
    dead = (u_row <= torch.tensor(float(dead_row), dtype=f32,
                                  device=device))[:, None]
    p_both = p_off + p_on
    code = ((u_pos <= p_off) * float(FAULT_POS_OFF)
            + (u_neg <= p_off) * float(FAULT_NEG_OFF)
            + ((u_pos > p_off) & (u_pos <= p_both)) * float(FAULT_POS_ON)
            + ((u_neg > p_off) & (u_neg <= p_both)) * float(FAULT_NEG_ON)
            + dead * float(FAULT_DEAD))
    return code.to(f32)


def column_ok_plane(cols: int, *, seed, dead_col, device=None) -> torch.Tensor:
    """(cols,) float32 column-health plane: 1.0 healthy, 0.0 dead driver."""
    u = _lane_uniforms(seed, _STREAM_COL, cols, device)
    return (u > torch.tensor(float(dead_col), dtype=torch.float32,
                             device=device)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Hard-fault model knobs (per-cell / per-line Bernoulli rates)."""

    stuck_on_rate: float = 0.0    # cell pinned at G_on = G_AP + G_FS
    stuck_off_rate: float = 0.0   # cell pinned at the G_AP floor
    dead_row_rate: float = 0.0    # word-line driver dead (whole row)
    dead_col_rate: float = 0.0    # bit-line driver dead (whole column)
    wear_per_cycle: float = 0.0   # per-write-cycle wear-out Bernoulli
    write_cycles: float = 0.0     # cycles endured -> folds into stuck-off
    drift_sigma: float = 0.0      # lognormal conductance drift (device only)
    seed: int = 0
    rate: float = 0.0             # headline knob of ``at_rate`` (reporting)

    @property
    def wear_rate(self) -> float:
        """P(cell has worn out open) after ``write_cycles`` cycles."""
        if self.wear_per_cycle <= 0.0 or self.write_cycles <= 0.0:
            return 0.0
        return 1.0 - (1.0 - self.wear_per_cycle) ** self.write_cycles

    @property
    def stuck_off_effective(self) -> float:
        """Stuck-off rate with endurance wear folded in (independent OR)."""
        return 1.0 - (1.0 - self.stuck_off_rate) * (1.0 - self.wear_rate)

    @property
    def cell_fault_rate(self) -> float:
        return self.stuck_on_rate + self.stuck_off_effective

    @property
    def any_faults(self) -> bool:
        return (self.cell_fault_rate > 0.0 or self.dead_row_rate > 0.0
                or self.dead_col_rate > 0.0 or self.drift_sigma > 0.0)

    @classmethod
    def at_rate(cls, rate: float, *, seed: int = 0,
                drift_sigma: float = 0.0) -> "FaultSpec":
        """Single-knob mix of the degradation sweeps: 35% stuck-on, 35%
        stuck-off, 20% dead rows, 10% dead columns."""
        r = float(rate)
        return cls(stuck_on_rate=0.35 * r, stuck_off_rate=0.35 * r,
                   dead_row_rate=0.20 * r, dead_col_rate=0.10 * r,
                   drift_sigma=drift_sigma, seed=seed, rate=r)

    def planes(self, rows: int, cols: int, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Concrete (code, col_ok) defect planes for one array."""
        code = fault_code_plane(
            rows, cols, seed=self.seed & _MASK, stuck_on=self.stuck_on_rate,
            stuck_off=self.stuck_off_effective, dead_row=self.dead_row_rate,
            device=device)
        col_ok = column_ok_plane(cols, seed=self.seed & _MASK,
                                 dead_col=self.dead_col_rate, device=device)
        return code, col_ok


@dataclasses.dataclass(frozen=True)
class RepairPolicy:
    """Array repair knobs (hashable)."""

    name: str = "none"
    spare_rows: int = 0          # remap capacity: worst rows -> spares
    spare_cols: int = 0          # revive capacity: dead columns -> spares
    mask_pairs: bool = False     # differential-pair-aware masking
    ecc_cells_per_row: int = 0   # lightweight ECC: stuck cells corrected/row


REPAIR_NONE = RepairPolicy()
REPAIR_SPARE = RepairPolicy(name="spare", spare_rows=8, spare_cols=8,
                            mask_pairs=True)
REPAIR_SPARE_ECC = RepairPolicy(name="spare+ecc", spare_rows=8, spare_cols=8,
                                mask_pairs=True, ecc_cells_per_row=1)
REPAIR_POLICIES = (REPAIR_NONE, REPAIR_SPARE, REPAIR_SPARE_ECC)


def apply_repair(code: torch.Tensor, col_ok: torch.Tensor,
                 policy: Optional[RepairPolicy]):
    """Transform the defect map as the repair controller would, draw-free
    (the same order as the reference): ECC clears up to
    ``ecc_cells_per_row`` stuck pairs per row, pair masking turns stuck-on
    pairs dead, spare rows clear the worst faulty rows (stable order on
    ties), spare columns revive the first dead columns."""
    if policy is None or policy == REPAIR_NONE:
        return code, col_ok
    rows = code.shape[0]
    zero = torch.zeros((), dtype=code.dtype, device=code.device)
    dead = fail_bit(code, FAULT_DEAD)
    if policy.ecc_cells_per_row > 0:
        stuck = (code > 0.0) & ~dead
        cum = torch.cumsum(stuck.to(torch.float32), dim=1)
        clear = stuck & (cum <= float(policy.ecc_cells_per_row))
        code = torch.where(clear, zero, code)
    if policy.mask_pairs:
        stuck_on = ((fail_bit(code, FAULT_POS_ON)
                     | fail_bit(code, FAULT_NEG_ON)) & ~dead)
        code = torch.where(stuck_on, zero + float(FAULT_DEAD), code)
    if policy.spare_rows > 0:
        row_bad = torch.sum((code > 0.0).to(torch.float32), dim=1)
        sel = torch.argsort(-row_bad, stable=True)[: policy.spare_rows]
        is_spare = torch.zeros((rows,), dtype=torch.bool, device=code.device)
        is_spare[sel] = True
        is_spare = is_spare & (row_bad > 0.0)
        code = torch.where(is_spare[:, None], zero, code)
    if policy.spare_cols > 0:
        dead_c = col_ok < 0.5
        cum_c = torch.cumsum(dead_c.to(torch.float32), dim=0)
        revive = dead_c & (cum_c <= float(policy.spare_cols))
        col_ok = torch.where(revive, torch.ones_like(col_ok), col_ok)
    return code, col_ok


def apply_cell_faults(code: torch.Tensor, g_pos: torch.Tensor,
                      g_neg: torch.Tensor, *, g_off, g_on):
    """Overwrite programmed conductances with the stuck/dead fault codes —
    the device-path twin of the decode in ``pos_neg_conductance`` (floor,
    then stuck-on, then dead)."""
    f32, dev = torch.float32, g_pos.device
    g_off = torch.as_tensor(g_off, dtype=f32, device=dev)
    g_on = torch.as_tensor(g_on, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    g_pos = torch.where(fail_bit(code, FAULT_POS_OFF), g_off, g_pos)
    g_neg = torch.where(fail_bit(code, FAULT_NEG_OFF), g_off, g_neg)
    g_pos = torch.where(fail_bit(code, FAULT_POS_ON), g_on, g_pos)
    g_neg = torch.where(fail_bit(code, FAULT_NEG_ON), g_on, g_neg)
    dead = fail_bit(code, FAULT_DEAD)
    g_pos = torch.where(dead, zero, g_pos)
    g_neg = torch.where(dead, zero, g_neg)
    return g_pos, g_neg


def drift_factors(spec: FaultSpec, rows: int, cols: int, *, negative: bool,
                  device=None) -> torch.Tensor:
    """(rows, cols) mean-preserving lognormal drift multipliers,
    exp(sigma z - sigma^2 / 2) (device path only)."""
    stream = _STREAM_DRIFT_N if negative else _STREAM_DRIFT_P
    lanes = _lane_seeds(spec.seed & _MASK, stream, rows * cols, device)
    z, _ = noise.normal_pair(lanes, 0)
    s = float(spec.drift_sigma)
    return torch.exp(s * z - 0.5 * s * s).reshape(rows, cols)
