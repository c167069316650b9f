"""Map LM-architecture decode onto the AFMTJ IMC hierarchy (port of
``repro.imc.mapping``).

The closed-form latency/energy mapping: decode-step inference is dominated
by weight-stationary GEMVs (every active parameter is one MAC), tiled over
``XBAR`` x ``XBAR`` crossbars with 8-bit weights bit-sliced over
``CELLS_PER_WEIGHT_8B`` cells, ``IMC_PARALLEL_ARRAYS`` arrays working at
once at the main-memory level; against the Cortex-A72's streaming GEMV,
plus the 1-bit (XNOR) variant of each IMC target.  ``map_all`` maps every
arch of a registry for both device kinds on ``imc.hierarchy``'s
subarray timings (the device write solve of ``circuit.subarray``).

The functional read-path accuracy of an arch's decode projection: one
decode-step projection computed through ``imc.analog_pipeline`` and scored
against the float32 matmul, and the accuracy-vs-adc_bits-vs-TMR surface,
projection level or, with ``model=``, model level (``imc.model_analog``).

The hard-fault repair yield model (DESIGN.md §13): the probability an
array's defects fit its repair capacity, the spare-line / ECC cell
overhead, and the (yield, overhead, latency stretch) factors the cost
models charge.  And the write/accuracy trade: ``write_energy_accuracy_
surface`` sizes write-verify attempt budgets from the measured
single-pulse WER, measures what each budget costs (``imc.write_path``) and
scores the decode projection with the residual bit errors injected.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.imc.cpu_model import CORTEX_A72, CPUModel

XBAR = 512                      # crossbar dimension (MM-level subarrays)
IMC_PARALLEL_ARRAYS = 1024      # arrays operating concurrently at MM (PiM)
ADC_E_PER_COL = 2.0e-12         # 6-bit column ADC energy [J]
ADC_T = 0.5e-9                  # per-tile conversion time (pipelined) [s]
CELLS_PER_WEIGHT_8B = 8         # bit-sliced int8: one cell per weight bit


@dataclasses.dataclass(frozen=True)
class ArchMapResult:
    arch: str
    t_cpu: float
    e_cpu: float
    t_imc: float
    e_imc: float
    t_imc_bnn: float
    e_imc_bnn: float
    tiles: float = 0.0           # XBAR^2 crossbar tiles, 8-bit mapping
    tiles_bnn: float = 0.0       # tiles for the binarized (1 cell/weight) map

    @property
    def speedup(self):
        return self.t_cpu / self.t_imc

    @property
    def energy_saving(self):
        return self.e_cpu / self.e_imc


def map_arch_decode(cfg: ArchConfig, hier,
                    cpu: CPUModel = CORTEX_A72) -> ArchMapResult:
    """One decode token of ``cfg`` on the MM level of ``hier`` (an
    ``imc.hierarchy.IMCHierarchy``) against ``cpu``."""
    n = cfg.active_param_count()
    tm = hier.levels["MM"].timings

    # CPU baseline: memory-bound GEMV stream (int8 weights)
    t_cpu = max(n * 1.0 / cpu.bw_dram,                      # 1 B/param traffic
                n * 0.125 / (cpu.ipc * cpu.freq_hz))        # SIMD MACs
    e_cpu = (n / cpu.line_bytes) * cpu.e_dram_line + n * 0.02e-12

    # crossbar tiles of XBAR x XBAR cells, 8 cells per 8-bit weight
    tiles = n * CELLS_PER_WEIGHT_8B / (XBAR * XBAR)
    waves = tiles / IMC_PARALLEL_ARRAYS                     # sequential waves
    t_tile = tm.t_read + ADC_T                              # analog GEMV + ADC
    t_wb = tm.t_write                  # activation write-back per tile group
    t_imc = waves * (t_tile + t_wb * 0.1)                   # writes pipelined
    e_mac = tm.e_read_bit                                   # per-cell read
    e_imc = (n * CELLS_PER_WEIGHT_8B * e_mac
             + tiles * XBAR * ADC_E_PER_COL                 # column ADCs
             + tiles * XBAR * tm.e_write_bit * 0.02)        # activation writes

    # 1-bit (XNOR) variant: 1 cell/weight, 8x fewer tiles, no ADC
    tiles_b = n / (XBAR * XBAR)
    waves_b = tiles_b / IMC_PARALLEL_ARRAYS
    t_imc_bnn = waves_b * (tm.t_logic2 + tm.t_write * 0.1)
    e_imc_bnn = n * tm.e_logic_bit + tiles_b * XBAR * tm.e_write_bit * 0.02

    return ArchMapResult(cfg.name, t_cpu, e_cpu, t_imc, e_imc,
                         t_imc_bnn, e_imc_bnn, tiles=tiles, tiles_bnn=tiles_b)


def map_all(archs: Dict[str, ArchConfig], device=None
            ) -> Dict[str, Dict[str, ArchMapResult]]:
    """``{kind: {arch: ArchMapResult}}`` for both device kinds."""
    from repro_torch.imc.hierarchy import build_hierarchy

    dev = resolve_device(device)
    out = {}
    for kind in ("afmtj", "mtj"):
        hier = build_hierarchy(kind, device=dev)
        out[kind] = {name: map_arch_decode(cfg, hier)
                     for name, cfg in archs.items()}
    return out


# --- hard-fault repair: capacity yield model + area/energy overheads --------
#
# The closed-form companion of ``imc.faults``' defect planes that the cost
# models charge (DESIGN.md §13): the probability an XBAR x XBAR array's
# defects fit the repair capacity (arrays that do not are fused out and
# their work re-runs on survivors, stretching latency by 1 / yield), and
# the spare-line / ECC cell overheads every array pays.  Pure float64
# Python, operation for operation the reference's.

def _poisson_cdf(k: int, lam: float) -> float:
    """P(X <= k) for X ~ Poisson(lam), summed term by term."""
    if lam <= 0.0:
        return 1.0
    term = math.exp(-lam)
    total = term
    for i in range(1, int(k) + 1):
        term *= lam / i
        total += term
    return min(total, 1.0)


def repair_yield(faults, policy=None, xbar: int = XBAR) -> float:
    """P(an XBAR x XBAR differential array is usable under ``policy``).

    A row is defective if its word line is dead or it holds more
    stuck differential pairs than ECC corrects (pair masking absorbs them
    all; without it one uncorrected stuck pair condemns the row).
    Defective row / column counts are Poisson and must fit the spares;
    the yield is the product of both fits."""
    from repro_torch.imc.faults import REPAIR_NONE

    pol = policy or REPAIR_NONE
    p_cell = min(faults.cell_fault_rate, 1.0)
    p_pair = 1.0 - (1.0 - p_cell) ** 2
    if pol.mask_pairs:
        p_row_cells = 0.0          # masked pairs never condemn a row
    else:
        lam_pair = xbar * p_pair
        p_row_cells = 1.0 - _poisson_cdf(pol.ecc_cells_per_row, lam_pair)
    p_row = min(faults.dead_row_rate
                + (1.0 - faults.dead_row_rate) * p_row_cells, 1.0)
    y_rows = _poisson_cdf(pol.spare_rows, xbar * p_row)
    y_cols = _poisson_cdf(pol.spare_cols, xbar * faults.dead_col_rate)
    return y_rows * y_cols


def repair_cell_overhead(policy=None, xbar: int = XBAR) -> float:
    """Cell / area factor a repaired array pays: the spare lines and the
    ECC side table (9 cells per correctable entry: 8-bit value + valid)."""
    from repro_torch.imc.faults import REPAIR_NONE

    pol = policy or REPAIR_NONE
    area = (1.0 + pol.spare_rows / xbar) * (1.0 + pol.spare_cols / xbar)
    ecc = 1.0 + 9.0 * pol.ecc_cells_per_row / xbar
    return area * ecc


def fault_cost_factors(faults, policy=None, xbar: int = XBAR
                       ) -> Tuple[float, float, float]:
    """(array_yield, cell_overhead, latency_stretch) for the cost models.
    Latency stretches by overhead / yield, the yield floored at 1e-3 so a
    hopeless (rate, policy) point stays finite; (1, 1, 1) without an
    active ``FaultSpec``."""
    if faults is None or not faults.any_faults:
        return 1.0, 1.0, 1.0
    y = repair_yield(faults, policy, xbar)
    ovh = repair_cell_overhead(policy, xbar)
    return y, ovh, ovh / max(y, 1e-3)


def decode_projection_shapes(cfg: ArchConfig, cap_k: int = 512,
                             cap_n: int = 512) -> Tuple[int, int]:
    """The arch's decode-dominant GEMV (d_model -> FFN fan-out), capped."""
    k = min(cfg.d_model, cap_k)
    n_full = cfg.d_ff if cfg.d_ff else 2 * cfg.d_model
    if cfg.moe is not None:
        n_full = cfg.moe.d_expert
    return k, min(n_full, cap_n)


def projection_draws(seed: int, k: int, n: int, batch: int):
    """(w, x): init-scaled (k, n) projection weights and (batch, k)
    unit-normal decode activations, float32 on the CPU, from a
    ``torch.Generator`` seeded with ``seed``.  The reference draws these
    with ``jax.random``; the tests hand its draws over by replacing this
    function."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    w = torch.randn((k, n), generator=gen) / torch.tensor(k ** 0.5)
    x = torch.randn((batch, k), generator=gen)
    return w, x


def decode_projection_accuracy(
    cfg: ArchConfig,
    kind: str = "afmtj",
    analog_cfg=None,
    mode: str = "analog",
    batch: int = 8,
    cap_k: int = 512,
    cap_n: int = 512,
    seed: Optional[int] = None,
    device=None,
    devices=None,
):
    """One decode-step projection of ``cfg`` through the analog path
    (``seed=None`` derives the draw from the arch name; ``devices`` splits
    the batch, as ``analog_pipeline.analog_matmul``)."""
    from repro_torch.imc.analog_pipeline import AnalogConfig, mvm_accuracy

    dev = resolve_device(device)
    analog_cfg = analog_cfg or AnalogConfig()
    k, n = decode_projection_shapes(cfg, cap_k, cap_n)
    if seed is None:
        seed = zlib.crc32(cfg.name.encode()) & 0x7FFFFFFF
    w, x = projection_draws(seed, k, n, batch)
    return mvm_accuracy(w, x, kind=kind, cfg=analog_cfg, mode=mode,
                        arch=cfg.name, device=dev, devices=devices)


def accuracy_surface(
    cfg: ArchConfig,
    kind: str = "afmtj",
    adc_bits: Sequence[int] = (4, 6, 8),
    tmrs: Sequence[float] = (0.8, 5.0),
    g_sigma: float = 0.0,
    variation=None,
    model: Optional[str] = None,
    device=None,
    **kw,
) -> Dict[Tuple[int, float], object]:
    """Accuracy-vs-``adc_bits``-vs-TMR surface for one arch: decode
    projection ``AccuracyReport``s, or with ``model=`` ("fake", "device",
    "bnn") the model-level ``ModelAccuracyReport``s of ``imc.model_analog``
    (``variation`` then names the systematic corner)."""
    from repro_torch.imc.analog_pipeline import AnalogConfig

    dev = resolve_device(device)
    if model is not None:
        from repro_torch.imc.model_analog import model_accuracy_surface

        assert g_sigma == 0.0, "model-level surface takes corners, not g_sigma"
        corner = variation.corners[0].name if variation is not None else "tt"
        reports = model_accuracy_surface(
            arch=cfg.name, kind=kind, mode=model, adc_bits=tuple(adc_bits),
            tmrs=tuple(tmrs), corners=(corner,), device=dev, **kw)
        return {(r.adc_bits, r.tmr): r for r in reports}

    out = {}
    for bits in adc_bits:
        for tmr in tmrs:
            acfg = AnalogConfig(adc_bits=bits, tmr=tmr, g_sigma=g_sigma,
                                variation=variation)
            out[(bits, tmr)] = decode_projection_accuracy(
                cfg, kind=kind, analog_cfg=acfg, device=dev, **kw)
    return out


# --- functional write path: accuracy vs the measured cost of writing -------

@dataclasses.dataclass(frozen=True)
class WriteAccuracyPoint:
    """One (WER target) operating point of the write/accuracy trade."""

    wer_target: float
    attempts_budget: int       # verify retries allotted to reach the target
    write_ber: float           # residual BER injected into programming
    e_write_bit: float         # measured mean write energy per cell [J]
    t_write_mean: float        # measured mean per-cell write latency [s]
    attempts_mean: float       # measured mean pulses per cell
    report: object             # decode-projection AccuracyReport at that BER


def write_energy_accuracy_surface(
    cfg: ArchConfig,
    kind: str = "afmtj",
    wer_targets: Sequence[float] = (3e-1, 1e-1, 1e-2, 1e-4),
    v_write: float = 1.0,
    policy=None,
    n_cells: int = 512,
    analog_cfg=None,
    max_attempt_budget: int = 64,
    device=None,
    **kw,
) -> Dict[float, WriteAccuracyPoint]:
    """Accuracy-vs-write-energy surface for one arch.  A single-pulse probe
    measures the WER of one attempt; each residual-WER target sizes a
    geometric attempt budget from it (capped at ``max_attempt_budget``),
    the write-verify scheduler measures that budget's energy, latency and
    residual BER (every write round one launch of the LLG kernel), and the
    residual errors go into the analog read path (``AnalogConfig.
    write_ber``) to score the decode projection (the bit-line MAC kernel).
    When every sampled cell verified, the BER falls back to the geometric
    estimate ``wer1 ** k``."""
    from repro_torch.imc.analog_pipeline import AnalogConfig
    from repro_torch.imc.write_path import WritePolicy, write_verify

    dev = resolve_device(device)
    pol = policy or WritePolicy(v_write=v_write)
    probe = write_verify(kind, n_cells,
                         dataclasses.replace(pol, max_attempts=1), dev)
    wer1 = probe.single_pulse_wer
    out = {}
    for target in wer_targets:
        if 0.0 < wer1 < 1.0:
            k = max(1, math.ceil(math.log(target) / math.log(wer1)))
            k = min(k, int(max_attempt_budget))
        else:
            k = 1 if wer1 == 0.0 else int(max_attempt_budget)
        r = write_verify(kind, n_cells,
                         dataclasses.replace(pol, max_attempts=k), dev)
        ber = r.residual_ber if r.residual_ber > 0.0 else float(wer1 ** k)
        acfg = dataclasses.replace(analog_cfg or AnalogConfig(),
                                   write_ber=float(ber))
        rep = decode_projection_accuracy(cfg, kind=kind, analog_cfg=acfg,
                                         device=dev, **kw)
        out[float(target)] = WriteAccuracyPoint(
            wer_target=float(target), attempts_budget=k,
            write_ber=float(ber), e_write_bit=r.energy_mean(),
            t_write_mean=float(r.latency.mean()),
            attempts_mean=r.attempts_mean, report=rep)
    return out
