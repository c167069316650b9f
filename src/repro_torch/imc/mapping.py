"""Functional read-path accuracy of an architecture's decode projection
(port of the accuracy half of ``repro.imc.mapping``): one decode-step
projection computed through ``imc.analog_pipeline`` and scored against the
float32 matmul, and the accuracy-vs-adc_bits-vs-TMR surface, projection
level or, with ``model=``, model level (``imc.model_analog``).

The closed-form latency/energy mapping of the reference module and
``write_energy_accuracy_surface`` wait for ROADMAP A8b.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig


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
