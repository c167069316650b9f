"""ADC sizing of the fake-analog operands: the (8, N) aux plane of
``fake_analog.fake_analog_kernel`` from statistics that stay on the
operands' device (the port's own kernel; the reference sizes these scalars
inside its jitted forward).

The ADC full scale is ``fs_sigmas`` column-current sigmas, ``(v_rms *
g_rms) * sqrt(k_rows)``, floored at 1e-30 and rounded to two significant
digits through a string (``adc_full_scale``); the decode gain is
``(x_scale * w_scale) / ((v_read * g_fs) * att_mean)`` (``decode_gain``);
both in float64.  The device path (``imc.analog_pipeline``) sizes its
host floats with these two functions, and the fake path's aux plane holds
them as float32 beside the attenuation rows and the broadcast cell
constants (``fake_analog.ROW_*``).  ``x_scale`` / ``w_scale`` are max |x|
and max |w|, 0 read as 1.

``adc_aux_kernel`` wraps the CUDA kernel in ``csrc/adc_sizing.cu``: CPU
tensors run the plain version ``ref.ref_adc_aux`` (the statistics read to
host floats); CUDA tensors launch the kernel or raise.  On the card no
value is read back to the host and no host value is copied onto the card:
the host's numbers ride the launch as arguments.  The kernel rounds by a
lookup in ``rounding_table()``, which ``round_2sig`` itself builds, so its
two scalars equal the plain version's bit for bit; the table is copied to
each card once per process.  ``adc_aux_kernel.launches`` counts launches;
``reset_counts()`` zeroes it.
"""
from __future__ import annotations

import functools
import math
from decimal import Decimal
from typing import Optional, Sequence

import torch

from repro_torch.kernels import analog_mac, build
from repro_torch.kernels.fake_analog import AUX_ROWS
from repro_torch.kernels.ref import ref_adc_aux

FLOOR = 1e-30
# the table's exact range is [FLOOR, TOP); its last entry sends every
# larger value to +inf, which stores as float32 as the value's own rounding
# does (both overflow)
TOP = 1e39


def round_2sig(y: float) -> float:
    """``y`` rounded to two significant digits through a string."""
    return float(f"{y:.2g}")


def adc_full_scale(v_rms: float, g_rms: float, k_rows: int,
                   full_scale_sigmas: float) -> float:
    """ADC full scale: ``full_scale_sigmas`` column-current sigmas (an
    independence estimate, float64) rounded to 2 significant digits through
    a string, as the reference's ``kernel_operands``."""
    i_sigma = v_rms * g_rms * math.sqrt(k_rows)
    return round_2sig(max(full_scale_sigmas * i_sigma, FLOOR))


def decode_gain(x_scale: float, w_scale: float, v_read: float, g_fs: float,
                att_mean: float) -> float:
    """Gain from ADC output back to weight x activation units (float64)."""
    return (x_scale * w_scale) / (v_read * g_fs * att_mean)


@functools.lru_cache(maxsize=None)
def rounding_table() -> tuple:
    """(bounds, values): ``round_2sig(y)`` is ``values[i]`` for
    ``bounds[i] <= y < bounds[i + 1]`` over [FLOOR, TOP), and +inf from
    ``bounds[-1]`` = TOP on.  Each value is a two-digit decimal d 10^e;
    each bound the least double that ``round_2sig`` sends to its value,
    found next to the decimal midpoint below it."""
    decimals = [Decimal(f"{d}e{e}") for e in range(-31, 38)
                for d in range(10, 100)] + [Decimal(f"{TOP:g}")]
    bounds, values = [FLOOR], [FLOOR]
    for lo, hi in zip(decimals, decimals[1:]):
        value = float(hi)
        y = float((lo + hi) / 2)
        while round_2sig(y) >= value:
            y = math.nextafter(y, 0.0)
        while round_2sig(y) < value:
            y = math.nextafter(y, math.inf)
        bounds.append(y)
        values.append(value)
    bounds.append(TOP)
    values.append(math.inf)
    return tuple(bounds), tuple(values)


@functools.lru_cache(maxsize=None)
def _device_table(index: int) -> torch.Tensor:
    """(2, T) float64 bounds and values on CUDA device ``index`` (one copy
    a process)."""
    return torch.tensor(rounding_table(), dtype=torch.float64,
                        device=torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _library():
    """The built library; B5, which runs on every aux plane, compiles beside
    it on first use (one nvcc each, together)."""
    build.build_many(("adc_sizing", "fake_analog"))
    return analog_mac.library("adc_sizing")


def adc_aux_kernel(att_p: torch.Tensor, att_n: torch.Tensor,
                   cell: Sequence[torch.Tensor], *, w_max: torch.Tensor,
                   x_max: torch.Tensor, att_mean: Optional[torch.Tensor],
                   g_rms: Optional[torch.Tensor],
                   v_rms: Optional[torch.Tensor], k_rows: int,
                   fs_sigmas: float, v_read: float, g_fs: float,
                   decode: bool, i_max: Optional[float]) -> torch.Tensor:
    """(8, N) float32 aux plane of one product.

    ``att_p`` / ``att_n``: (N,) attenuation rows; ``cell``: the 0-dim
    float32 G_AP, G_FS, G_SCALE, R_ACCESS; ``w_max`` / ``x_max`` / the
    optional ``att_mean`` (None: 1, no IR drop) and, when ``i_max`` is None
    (the full scale sized here), ``g_rms`` / ``v_rms``: 0-dim float32
    statistics; the rest host floats (``g_fs`` the float64 G_P - G_AP)."""
    if i_max is None and (g_rms is None or v_rms is None):
        raise ValueError("adc_sizing: sizing the full scale needs g_rms and "
                         "v_rms")
    kw = dict(w_max=w_max, x_max=x_max, att_mean=att_mean, g_rms=g_rms,
              v_rms=v_rms, k_rows=k_rows, fs_sigmas=fs_sigmas, v_read=v_read,
              g_fs=g_fs, decode=decode, i_max=i_max)
    n = att_p.numel()
    if att_p.is_cpu:
        return ref_adc_aux(att_p, att_n, cell, **kw)
    stats = [w_max, x_max] + [t for t in (att_mean, g_rms, v_rms)
                              if t is not None]
    index = analog_mac.cuda_index("adc_sizing", att_p, att_n, *cell, *stats)
    att_p, att_n = (analog_mac.f32(t).reshape(n) for t in (att_p, att_n))
    cell = [analog_mac.f32(t) for t in cell]
    w_max, x_max, att_mean, g_rms, v_rms = (
        None if t is None else analog_mac.f32(t)
        for t in (w_max, x_max, att_mean, g_rms, v_rms))
    table = _device_table(index)
    aux = torch.empty((AUX_ROWS, n), dtype=torch.float32,
                      device=att_p.device)
    if n:
        analog_mac.launch(
            "adc_sizing", _library().adc_aux_launch, index, att_p.data_ptr(),
            att_n.data_ptr(), *(t.data_ptr() for t in cell),
            w_max.data_ptr(), x_max.data_ptr(), analog_mac.ptr(att_mean),
            analog_mac.ptr(g_rms), analog_mac.ptr(v_rms), table.data_ptr(),
            table.shape[1], aux.data_ptr(), n, math.sqrt(k_rows),
            float(fs_sigmas), float(v_read), float(g_fs), int(bool(decode)),
            int(i_max is not None), 0.0 if i_max is None else float(i_max))
        adc_aux_kernel.launches += 1
    return aux


def reset_counts() -> None:
    adc_aux_kernel.launches = 0


reset_counts()
