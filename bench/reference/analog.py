"""Plain reference of one fake-analog product ``x @ w`` on an AFMTJ
differential crossbar pair.

The chain, written from the device description in the configuration file
(its ``analog`` block) and not from the program:

1. normalise the weights by their largest magnitude and encode each as a
   pair of cells, G+ = G_AP + max(w, 0) G_FS and G- = G_AP + max(-w, 0)
   G_FS, where G_P and G_AP are the junction conductances R_P = RA / area,
   R_AP = R_P (1 + TMR) in series with the access transistor;
2. at a slow corner, the junction behind each cell conductance is scaled
   by 1 / r_factor and put back in series with the transistor;
3. residual write errors leave a cell at the G_AP floor: two Bernoulli
   planes (positive, negative cell) drawn from PyTorch's CPU Mersenne
   twister seeded with ``(seed * 0x9E3779B1 + 0x5EB) mod 2**32``;
4. IR drop: each column's current is attenuated by 1 / (1 + R_line G_col),
   R_line = r_wire rows / 2, with G_col the column's summed conductance;
5. activations become word-line voltages v = v_read x / max|x|;
6. the column currents I = v @ (att+ G+ - att- G-) go through a signed
   mid-tread ADC whose full scale is ``full_scale_sigmas`` column-current
   sigmas (v_rms g_rms sqrt(rows)), rounded to two significant digits;
7. the codes are decoded back by (max|x| max|w|) / (v_read G_FS att_mean).

Every product runs through ``prec.mm`` so that the control can lower its
precision.  Host scalars are Python floats (float64), planes float32.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
BER_SALT = 0x5EB
GOLDEN = 0x9E3779B1


def _f32(val, device) -> torch.Tensor:
    return torch.tensor(float(val), dtype=F32, device=device)


def cell_constants(analog: dict, tmr: float) -> dict:
    """G_AP and G_FS of the cell pair (float32 rounding of each step)."""
    area = analog["junction_lx_m"] * analog["junction_ly_m"]
    r_p = analog["ra_product_ohm_m2"] / area
    r_ap = r_p * (1.0 + tmr)
    r_acc = analog["r_access_ohm"]

    def series(r_junction):
        g = torch.tensor(1.0 / r_junction, dtype=F32)
        return float(g / (1.0 + r_acc * g))

    g_p, g_ap = series(r_p), series(r_ap)
    return {"g_ap": g_ap, "g_fs": g_p - g_ap}


def write_error_planes(seed: int, ber: float, shape, device):
    """(positive, negative) cells left at the floor by a residual write
    error, drawn on the host and moved to ``device``."""
    gen = torch.Generator(device="cpu").manual_seed(
        (int(seed) * GOLDEN + BER_SALT) & 0xFFFFFFFF)
    u_pos = torch.rand(tuple(shape), generator=gen)
    u_neg = torch.rand(tuple(shape), generator=gen)
    return (u_pos < ber).to(device), (u_neg < ber).to(device)


def analog_product(x: torch.Tensor, w: torch.Tensor, analog: dict,
                   point: dict, prec, with_step: bool = False):
    """(M, K) x (K, N) -> (M, N) float32 through the analog chain at one
    surface point (``adc_bits``, ``tmr``, ``corner``, ``write_ber``,
    ``seed``); with ``with_step`` also the output's value of one ADC
    code."""
    dev = w.device
    x = x.to(F32)
    w = w.to(F32)
    k_rows = w.shape[0]
    cells = cell_constants(analog, point["tmr"])
    g_ap, g_fs = _f32(cells["g_ap"], dev), _f32(cells["g_fs"], dev)
    r_acc = _f32(analog["r_access_ohm"], dev)

    w_scale = float(w.abs().max()) or 1.0
    wn = w / _f32(w_scale, dev)
    g_pos = g_ap + torch.clamp_min(wn, 0.0) * g_fs
    g_neg = g_ap + torch.clamp_min(-wn, 0.0) * g_fs
    del wn
    r_factor = analog["corners"][point["corner"]]["r_factor"]
    if r_factor != 1.0:
        scale = _f32(1.0 / r_factor, dev)

        def corner(g):
            g_j = (g / (1.0 - r_acc * g)) * scale
            return g_j / (1.0 + r_acc * g_j)

        g_pos, g_neg = corner(g_pos), corner(g_neg)
    if point["write_ber"] > 0.0:
        f_pos, f_neg = write_error_planes(point["seed"], point["write_ber"],
                                          w.shape, dev)
        g_pos = torch.where(f_pos, g_ap, g_pos)
        g_neg = torch.where(f_neg, g_ap, g_neg)
        del f_pos, f_neg

    r_line = analog["r_wire_per_cell_ohm"] * k_rows / 2.0
    att_pos = 1.0 / (1.0 + r_line * torch.sum(g_pos, dim=0))
    att_neg = 1.0 / (1.0 + r_line * torch.sum(g_neg, dim=0))
    att_mean = float(0.5 * (torch.mean(att_pos) + torch.mean(att_neg)))
    g_diff = att_pos[None, :] * g_pos - att_neg[None, :] * g_neg
    del g_pos, g_neg

    x_scale = float(x.abs().max()) or 1.0
    v_read = analog["v_read_v"]
    v = (_f32(v_read, dev) * x) / _f32(x_scale, dev)
    g_rms = float(torch.sqrt(torch.mean(g_diff * g_diff)))
    v_rms = float(torch.sqrt(torch.mean(v * v)))
    sigma = v_rms * g_rms * math.sqrt(k_rows)
    i_max = float(f"{max(analog['full_scale_sigmas'] * sigma, 1e-30):.2g}")
    gain = (x_scale * w_scale) / (v_read * cells["g_fs"] * att_mean)

    current = prec.mm(v, g_diff)
    del g_diff
    levels = _f32(2 ** (point["adc_bits"] - 1) - 1, dev)
    i_max_t = _f32(i_max, dev)
    code = torch.round(torch.clamp(current / i_max_t, -1.0, 1.0) * levels)
    y = (code / levels * i_max_t) * _f32(gain, dev)
    if with_step:
        return y, i_max / float(levels) * gain
    return y
