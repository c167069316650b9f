"""Hierarchical IMC organization (paper Fig. 2, after CHIME).

Port of ``repro.imc.hierarchy``: AFMTJ (or MTJ) subarrays embedded at L1,
L2 and main memory (32 KB L1, 1 MB L2, 8 GB main memory); each level
contributes concurrently operating subarrays and a controller pipelines
row-granular operations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

from repro_torch.circuit.bitline import BitlineParams
from repro_torch.circuit.senseamp import SenseAmpParams
from repro_torch.circuit.subarray import SubarrayTimings, make_subarray


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    name: str
    capacity_bytes: int
    rows: int
    cols: int
    n_active_subarrays: int     # concurrently operating compute subarrays
    c_per_cell_scale: float     # line-capacitance scale vs the L1 baseline
    e_periph_row_op: float      # decoder+driver+controller energy / row op [J]


# PiC at L1+L2, PiM at main memory.
LEVELS = (
    LevelSpec("L1", 32 * 1024, 256, 256, 2, 1.0, 1.2e-12),
    LevelSpec("L2", 1 * 1024 * 1024, 256, 256, 4, 1.3, 1.8e-12),
    LevelSpec("MM", 8 * 1024 * 1024 * 1024, 512, 512, 16, 2.0, 3.6e-12),
)


@dataclasses.dataclass(frozen=True)
class IMCLevel:
    spec: LevelSpec
    timings: SubarrayTimings

    @property
    def row_bits(self) -> int:
        return self.spec.cols * self.spec.n_active_subarrays


@dataclasses.dataclass(frozen=True)
class IMCHierarchy:
    kind: str                       # "afmtj" | "mtj"
    levels: Dict[str, IMCLevel]

    def level_for_footprint(self, n_bytes: int) -> IMCLevel:
        """Smallest level whose capacity holds the working set (PiC first)."""
        for lv in LEVELS:
            if n_bytes <= lv.capacity_bytes // 2:   # half data, half compute
                return self.levels[lv.name]
        return self.levels["MM"]


def build_hierarchy(
    kind: Literal["afmtj", "mtj"],
    v_write: float = 1.0,
    wer_target: Optional[float] = None,
    write_percentile: Optional[float] = None,
    read_percentile: Optional[float] = None,
    offset_sigma: float = 0.0,
    device=None,
) -> IMCHierarchy:
    """``wer_target`` sizes write pulses from the thermal-tail campaign;
    ``write_percentile`` (e.g. 99.0) measures per-level write timings from
    the write-verify retry scheduler at that row-time percentile;
    ``read_percentile`` measures per-level sense times from the worst
    corner's (D2D x sense-amp offset) Monte-Carlo at that percentile, with
    ``offset_sigma`` [V] the sense amp's input-referred offset spread."""
    levels = {}
    sa = SenseAmpParams(offset_sigma=offset_sigma)
    for spec in LEVELS:
        bl = BitlineParams(c_per_cell=0.03e-15 * spec.c_per_cell_scale,
                           rows=spec.rows)
        sub = make_subarray(kind, rows=spec.rows, cols=spec.cols,
                            v_write=v_write, bl=bl, sa=sa,
                            wer_target=wer_target,
                            write_percentile=write_percentile,
                            read_percentile=read_percentile, device=device)
        levels[spec.name] = IMCLevel(spec=spec, timings=sub.timings)
    return IMCHierarchy(kind=kind, levels=levels)
