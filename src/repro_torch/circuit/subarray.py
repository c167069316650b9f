"""AFMTJ/MTJ subarray model: rows x cols 1T1J array + periphery.

Port of ``repro.circuit.subarray``.  ``make_subarray`` runs the device
write solve once at the array's write voltage (or, with
``write_percentile``, the measured write-verify retry distribution of
``imc.write_path``) and the closed-form circuit models for read/logic
timing (or, with ``read_percentile``, the measured sense time of
``imc.read_path``), producing the ``SubarrayTimings`` the IMC hierarchy
consumes.

Latency per op (row-granular, all columns in parallel):
  read   : t_bl_settle + t_sa
  logic  : t_bl_settle + t_sa(multi-row differential)  [2-3 activated rows]
  write  : t_write(V) from the LLG device model (incl. bit-line RC), or the
           measured row write time at ``write_percentile``
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.circuit.bitline import (BitlineParams, bitline_settle_time,
                                         write_path_rc)
from repro_torch.circuit.senseamp import (SenseAmpParams, resolve_logic,
                                          sense_delay)
from repro_torch.core.device import read_energy, simulate_write
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams


@dataclasses.dataclass(frozen=True)
class SubarrayTimings:
    """Per-operation latency [s] / energy-per-bit [J] for one subarray."""

    t_read: float
    t_write: float
    t_logic2: float          # 2-row ops (nand/nor/and/or/xor)
    t_logic3: float          # 3-row (majority — the adder carry primitive)
    e_read_bit: float
    e_write_bit: float
    e_logic_bit: float       # 2-row logic: two cells conduct per column
    e_logic3_bit: float      # 3-row logic: three cells conduct per column
    rows: int
    cols: int
    write_attempts: float = 1.0        # mean pulses per cell write
    write_residual_ber: float = 0.0    # bit-error rate left after retries
    write_percentile: Optional[float] = None  # None = closed-form single pulse
    read_yield: float = 1.0            # worst-corner Monte-Carlo sense yield
    read_percentile: Optional[float] = None   # None = deterministic sense time

    @property
    def row_bits(self) -> int:
        return self.cols


@dataclasses.dataclass
class Subarray:
    """Functional + timed subarray."""

    dev: DeviceParams
    bl: BitlineParams
    sa: SenseAmpParams
    timings: SubarrayTimings
    state: torch.Tensor  # (rows, cols) uint8 bits

    def write_row(self, row: int, bits: torch.Tensor) -> "Subarray":
        self.state[row] = bits.to(torch.uint8)
        return self

    def read_row(self, row: int) -> torch.Tensor:
        return self.state[row]

    def logic(self, rows: tuple, op: str) -> torch.Tensor:
        """In-array logic across the given rows, resolved through the analog
        bit-line + sense-amp path (per column)."""
        bits = self.state[list(rows)]                    # (k, cols)
        out, _ = resolve_logic(bits.T, op, self.dev, self.bl, self.sa)
        return out.to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _characterize_write(kind: str, v_write: float, device=None):
    """Pure-device write cost (t_rc = 0), cached across subarray builds."""
    dev = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    n_steps, dt = (16000, 0.05e-12) if kind == "afmtj" else (40000, 0.1e-12)
    wr = simulate_write(dev, v_write, n_steps=n_steps, dt=dt, t_rc=0.0,
                        device=device)
    return float(wr.write_latency), float(wr.energy)


def _worst_case_logic_delay(op_rows: int, dev, bl, sa, device) -> float:
    """Max sense delay across all input combinations of a k-row op."""
    combos = np.array(
        [[(i >> b) & 1 for b in range(op_rows)] for i in range(2**op_rows)],
        dtype=np.float32)
    op = "and" if op_rows != 3 else "maj"
    _, delays = resolve_logic(torch.as_tensor(combos, device=device), op,
                              dev, bl, sa)
    return float(torch.max(delays))


def make_subarray(
    kind: Literal["afmtj", "mtj"],
    rows: int = 256,
    cols: int = 256,
    v_write: float = 1.0,
    bl: Optional[BitlineParams] = None,
    sa: Optional[SenseAmpParams] = None,
    wer_target: Optional[float] = None,
    write_percentile: Optional[float] = None,
    read_percentile: Optional[float] = None,
    device=None,
) -> Subarray:
    dev_t = resolve_device(device)
    dev = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    bl = bl or BitlineParams(rows=rows)
    sa = sa or SenseAmpParams()

    # --- device-level write characterization -------------------------------
    t_rc = write_path_rc(bl)
    w_attempts, w_ber = 1.0, 0.0
    if write_percentile is not None:
        # measured stochastic write path: row write time at the controller
        # percentile of the write-verify retry distribution, mean per-bit
        # energy over issued pulses; t_rc rides inside every attempt cycle
        from repro_torch.imc.write_path import measured_write_timings

        pulse = None
        if wer_target is not None:
            from repro_torch.imc.write_margin import wer_margined_pulse

            pulse = wer_margined_pulse(kind, v_write, wer_target,
                                       device=device)
        mw = measured_write_timings(kind, v_write=v_write, cols=cols,
                                    percentile=write_percentile, t_rc=t_rc,
                                    pulse=pulse, device=device)
        t_write, e_write = mw.t_write, mw.e_write_bit
        w_attempts, w_ber = mw.attempts_mean, mw.residual_ber
    else:
        t_sw, e_sw = _characterize_write(kind, v_write, device)
        if wer_target is not None:
            # thermal-tail margin from the Monte-Carlo campaign engine
            from repro_torch.imc.write_margin import wer_margined_pulse

            t_pulse = wer_margined_pulse(kind, v_write, wer_target,
                                         device=device)
            t_pulse = max(t_pulse, t_sw)
            e_sw = e_sw + v_write**2 / dev.r_antiparallel * (t_pulse - t_sw)
            t_sw = t_pulse
        t_write = t_sw + t_rc
        e_write = e_sw + v_write**2 / dev.r_parallel * t_rc

    # --- circuit-level read/logic characterization --------------------------
    g_worst = torch.tensor(1.0 / dev.r_antiparallel, dtype=torch.float32,
                           device=dev_t)
    t_settle = float(bitline_settle_time(g_worst, bl))
    r_yield = 1.0
    if read_percentile is not None:
        # measured read path (DESIGN.md §10): the sense time at the
        # percentile of the (corner x D2D x offset) Monte-Carlo, worst
        # corner, and the worst corner's sense yield
        from repro_torch.imc.read_path import measured_read_timings

        mr = measured_read_timings(kind, v_read=bl.v_read,
                                   percentile=read_percentile, sa=sa, bl=bl,
                                   device=device)
        t_sense = mr.t_sense
        r_yield = mr.read_yield
    else:
        i_p = bl.v_read / dev.r_parallel
        i_ap = bl.v_read / dev.r_antiparallel
        t_sense = float(sense_delay(torch.tensor((i_p - i_ap) / 2.0,
                                                 dtype=torch.float32,
                                                 device=dev_t), sa))
    t_read = t_settle + t_sense
    t_logic2 = t_settle + _worst_case_logic_delay(2, dev, bl, sa, dev_t)
    t_logic3 = t_settle + _worst_case_logic_delay(3, dev, bl, sa, dev_t)

    e_read = read_energy(dev, t_read=t_read, v_read=bl.v_read) + sa.e_per_sense
    # k-row logic draws read current through k activated cells
    e_logic = 2.0 * read_energy(dev, t_read=t_logic2, v_read=bl.v_read) + sa.e_per_sense
    e_logic3 = 3.0 * read_energy(dev, t_read=t_logic3, v_read=bl.v_read) + sa.e_per_sense

    timings = SubarrayTimings(
        t_read=t_read, t_write=t_write, t_logic2=t_logic2, t_logic3=t_logic3,
        e_read_bit=e_read, e_write_bit=e_write, e_logic_bit=e_logic,
        e_logic3_bit=e_logic3, rows=rows, cols=cols,
        write_attempts=w_attempts, write_residual_ber=w_ber,
        write_percentile=write_percentile, read_yield=r_yield,
        read_percentile=read_percentile)
    state = torch.zeros((rows, cols), dtype=torch.uint8, device=dev_t)
    return Subarray(dev=dev, bl=bl, sa=sa, timings=timings, state=state)
