"""The fake-analog operand preamble as the port ran it before its scalars
stayed on the card: every statistic read to a host float, the ADC full
scale and the decode gain sized on the host (``analog_pipeline``'s
``adc_full_scale`` / ``decode_gain``), the aux plane stacked from
full-length rows.  ``tests/test_torch_adc_sizing.py`` (CPU) and
``tests/test_torch_adc_sizing_cuda.py`` (the card) hold
``imc.model_analog.fake_operands`` to it.  Plain PyTorch, no JAX."""
import torch

from repro_torch.circuit.bitline import column_ir_drop
from repro_torch.imc import analog_pipeline as ap
from repro_torch.imc import faults as hard_faults
from repro_torch.kernels.fake_analog import (AUX_ROWS, ROW_ATT_NEG, ROW_ATT_POS,
                                             ROW_DECODE, ROW_G_AP, ROW_G_FS,
                                             ROW_G_SCALE, ROW_I_MAX,
                                             ROW_R_ACCESS, pos_neg_conductance)

_F32 = torch.float32


def host_fake_operands(x, w, setup, bl):
    """(v, wn, fail, aux) with every preamble scalar read to the host;
    ``setup`` is ``imc.model_analog.fake_setup``'s."""
    s = setup
    x = x.to(_F32)
    w = w.to(_F32)
    dev = w.device
    k_rows, n_cols = w.shape
    g_ap, g_fs = s.g_ap, s.g_fs

    w_scale = float(torch.max(torch.abs(w)))
    if w_scale == 0.0:
        w_scale = 1.0
    wn = w / ap._scalar(w_scale, dev)

    if s.ber > 0.0:
        # the same cells as program_weights' residual write errors
        f_pos, f_neg = ap.write_ber_masks(s.seed, s.ber, wn.shape, dev)
        fail = f_pos.to(_F32) + 2.0 * f_neg.to(_F32)
    else:
        fail = torch.zeros_like(wn)

    col_ok = None
    if s.faults is not None:
        # fault bits are disjoint from the write-ber bits: + is bitwise OR
        fs = s.faults
        code = hard_faults.fault_code_plane(
            k_rows, n_cols, seed=fs.seed & 0xFFFFFFFF,
            stuck_on=fs.stuck_on_rate, stuck_off=fs.stuck_off_effective,
            dead_row=fs.dead_row_rate, device=dev)
        col_ok = hard_faults.column_ok_plane(
            n_cols, seed=fs.seed & 0xFFFFFFFF, dead_col=fs.dead_col_rate,
            device=dev)
        code, col_ok = hard_faults.apply_repair(code, col_ok, s.repair)
        fail = fail + code

    tp, tn = pos_neg_conductance(wn, fail, g_ap, g_fs, s.g_scale,
                                 s.r_access, apply_fet=s.apply_fet,
                                 use_fail=s.fail_plane)
    att_mean = 1.0
    if s.ir_drop:
        att_p = column_ir_drop(torch.sum(tp, dim=0), bl)
        att_n = column_ir_drop(torch.sum(tn, dim=0), bl)
        if col_ok is None:
            att_mean = float(0.5 * (torch.mean(att_p) + torch.mean(att_n)))
        else:
            # dead bit lines read zero; the decode gain calibrates over
            # live columns only (the device path's association)
            live = ap._scalar(max(float(torch.sum(col_ok)), 1.0), dev)
            att_mean = float(0.5 * (torch.sum(att_p * col_ok) / live
                                    + torch.sum(att_n * col_ok) / live))
            att_p = att_p * col_ok
            att_n = att_n * col_ok
    else:
        ones = torch.ones((n_cols,), dtype=_F32, device=dev)
        att_p = ones if col_ok is None else ones * col_ok
        att_n = att_p

    x_scale = float(torch.max(torch.abs(x)))
    if x_scale == 0.0:
        x_scale = 1.0
    v = (s.v_read * x) / ap._scalar(x_scale, dev)

    if s.i_max is not None:
        i_max = s.i_max
    else:
        g_diff = att_p[None, :] * tp - att_n[None, :] * tn
        g_rms = float(torch.sqrt(torch.mean(g_diff * g_diff)))
        v_rms = float(torch.sqrt(torch.mean(v * v)))
        i_max = ap.adc_full_scale(v_rms, g_rms, k_rows, s.fs_sigmas)
    dec = (ap.decode_gain(x_scale, w_scale, s.v_read_host, s.g_fs_host,
                          att_mean) if s.decode else 1.0)

    def full(val):
        return torch.broadcast_to(torch.as_tensor(val, dtype=_F32,
                                                  device=dev), (n_cols,))

    rows = [None] * AUX_ROWS
    rows[ROW_ATT_POS], rows[ROW_ATT_NEG] = att_p, att_n
    rows[ROW_I_MAX], rows[ROW_DECODE] = full(i_max), full(dec)
    rows[ROW_G_AP], rows[ROW_G_FS] = full(g_ap), full(g_fs)
    rows[ROW_G_SCALE], rows[ROW_R_ACCESS] = full(s.g_scale), full(s.r_access)
    return v, wn, fail, torch.stack(rows)
