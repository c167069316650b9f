"""Analytical ARM Cortex-A72 baseline (paper Sec. IV-A).

2 GHz, 32 KB L1 / 1 MB L2 / 8 GB DRAM.  Workload kernels are modeled as
NEON-vectorized streaming loops: per-element cost = max(compute-bound,
memory-bound) where the compute term comes from the kernel's instruction
mix (scalar instructions / 128-bit SIMD lanes) and the memory term from the
level the working set streams out of.

Energy: per-instruction core energy + per-access cache/DRAM energy, with
constants in the range published for A72-class cores at 16 nm (core
~30 pJ/instr incl. pipeline overheads; L1 ~15 pJ, L2 ~60 pJ per 64 B
line; LPDDR4X-class DRAM ~0.3 nJ per 64 B line ~ 4.7 pJ/B active energy —
the A72 baseline is a mobile SoC).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CPUModel:
    freq_hz: float = 2.0e9
    ipc: float = 2.0                  # sustained on streaming kernels
    simd_lanes_8b: int = 16           # 128-bit NEON
    e_instr: float = 30e-12           # core energy / instruction [J]
    # memory system
    l1_bytes: int = 32 * 1024
    l2_bytes: int = 1 * 1024 * 1024
    bw_l1: float = 32e9               # sustained stream bandwidth [B/s]
    bw_l2: float = 20e9
    bw_dram: float = 10e9
    e_l1_line: float = 15e-12         # energy / 64B line
    e_l2_line: float = 60e-12
    e_dram_line: float = 0.3e-9       # LPDDR4X-class mobile DRAM
    line_bytes: int = 64

    def stream_level(self, footprint_bytes: int) -> str:
        if footprint_bytes <= self.l1_bytes:
            return "L1"
        if footprint_bytes <= self.l2_bytes:
            return "L2"
        return "DRAM"

    def kernel_time_energy(
        self,
        n_elems: int,
        instrs_per_elem: float,
        simd_fraction: float,
        bytes_per_elem: float,
        footprint_bytes: int,
    ):
        """Return (seconds, joules) for a streaming kernel.

        instrs_per_elem: scalar-equivalent instruction count per element.
        simd_fraction:   fraction of those instructions that vectorize
                         across ``simd_lanes_8b`` lanes.
        bytes_per_elem:  memory traffic per element (read+write).
        """
        eff_instrs = n_elems * (
            instrs_per_elem * (1.0 - simd_fraction)
            + instrs_per_elem * simd_fraction / self.simd_lanes_8b
        )
        t_compute = eff_instrs / (self.ipc * self.freq_hz)

        level = self.stream_level(footprint_bytes)
        bw = {"L1": self.bw_l1, "L2": self.bw_l2, "DRAM": self.bw_dram}[level]
        traffic = n_elems * bytes_per_elem
        t_memory = traffic / bw

        t = max(t_compute, t_memory)

        e_line = {
            "L1": self.e_l1_line,
            "L2": self.e_l1_line + self.e_l2_line,
            "DRAM": self.e_l1_line + self.e_l2_line + self.e_dram_line,
        }[level]
        e = eff_instrs * self.e_instr + (traffic / self.line_bytes) * e_line
        return t, e


CORTEX_A72 = CPUModel()
