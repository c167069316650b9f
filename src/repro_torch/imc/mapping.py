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

The fault-repair yield model and ``write_energy_accuracy_surface`` wait
for ROADMAP A4b + A8b.
"""
from __future__ import annotations

import dataclasses
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
):
    """One decode-step projection of ``cfg`` through the analog path
    (``seed=None`` derives the draw from the arch name)."""
    from repro_torch.imc.analog_pipeline import AnalogConfig, mvm_accuracy

    dev = resolve_device(device)
    analog_cfg = analog_cfg or AnalogConfig()
    k, n = decode_projection_shapes(cfg, cap_k, cap_n)
    if seed is None:
        seed = zlib.crc32(cfg.name.encode()) & 0x7FFFFFFF
    w, x = projection_draws(seed, k, n, batch)
    return mvm_accuracy(w, x, kind=kind, cfg=analog_cfg, mode=mode,
                        arch=cfg.name, device=dev)


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
