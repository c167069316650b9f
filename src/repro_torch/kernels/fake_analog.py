"""Fused fake-analog MVM: programming, IR drop and ADC in one pass (port of
``repro.kernels.fake_analog``).

The differential conductance pair is replayed per element from the
normalized weights inside the matmul, in the order of ``program_weights``:
targets G_AP + max(+-wn, 0) G_FS, the optional access-FET / corner round
trip, the fail/fault code decode (floor -> stuck-on -> dead), the
per-column IR attenuation rows; then one product with the voltages, the
ADC on the per-column full scale and the decode gain.  Scalars ride an
(8, N) aux plane (``ROW_*``).

``fake_analog_kernel`` wraps the CUDA kernel in ``csrc/fake_analog.cu``
(replaces the Pallas ``_fake_kernel``: a producer warpgroup replays the
conductances into a shared-memory ring that consumer warpgroups run the
bit-line MAC's float32 mainloop on; it takes the bit-line MAC's split-K
chunks): CPU tensors run the plain version ``ref.ref_fake_analog``, CUDA
tensors launch the kernel or raise (also when the library's register count
is not the one its warpgroup split assumes: error -1).  The kernel takes
finite ``wn`` and fail codes 0 .. ``FAIL_CODE_MAX``.
``fake_analog_kernel.launches`` counts mainloop launches,
``.reduce_launches`` reduce-pass launches (calls that split K) and
``.launch_shapes`` mainloop launches by (M, K, N) (``analog_mac`` module
note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import analog_mac
from repro_torch.kernels.ref import ref_fake_analog

# aux plane row layout (8, N): per-column planes first, broadcast scalars
# (stored across the full row) after
ROW_ATT_POS = 0     # per-column IR attenuation, positive array
ROW_ATT_NEG = 1     # per-column IR attenuation, negative array
ROW_I_MAX = 2       # ADC full-scale current [A]
ROW_DECODE = 3      # decode gain back to weight/activation units
ROW_G_AP = 4        # effective AP-state conductance (G_AP floor) [S]
ROW_G_FS = 5        # unit-weight differential conductance G_P - G_AP [S]
ROW_G_SCALE = 6     # systematic corner junction conductance factor 1/r_f
ROW_R_ACCESS = 7    # access transistor on-resistance [Ohm]
AUX_ROWS = 8

# ``fail``-plane bit codes: a float32 bit-OR of small powers of two, exact
# up to 127.  Bits 1/2 are write-verify fails, 4..64 the hard-fault codes
# of ``imc.faults``.
FAIL_POS = 1        # write-verify fail: positive cell at the G_AP floor
FAIL_NEG = 2        # write-verify fail: negative cell at the G_AP floor
FAULT_POS_OFF = 4   # hard stuck-at-G_off: positive cell pinned at G_AP
FAULT_NEG_OFF = 8   # hard stuck-at-G_off: negative cell pinned at G_AP
FAULT_POS_ON = 16   # hard stuck-at-G_on: positive cell pinned at G_AP+G_FS
FAULT_NEG_ON = 32   # hard stuck-at-G_on: negative cell pinned at G_AP+G_FS
FAULT_DEAD = 64     # dead differential pair (dead row driver / repair mask)
FAIL_CODE_MAX = 127

# the library whose tile sets the K chunks (the bit-line MAC's: B5 and B3
# then add the same products in the same order)
SPLIT_TILE = "analog_mac"


def fail_bit(code: torch.Tensor, bit: int) -> torch.Tensor:
    """True where integer bit ``bit`` is set in the float32 code plane:
    ``floor(code * (1/bit)) mod 2 >= 1``, float arithmetic as the kernel's
    (1/bit is a power of two, so every step is exact)."""
    return torch.remainder(torch.floor(code * (1.0 / bit)), 2.0) >= 1.0


def pos_neg_conductance(wn, fail, g_ap, g_fs, g_scale, r_access, *,
                        apply_fet: bool, use_fail: bool):
    """Per-cell (g_pos, g_neg) pre-IR-drop conductances — the replay of
    ``program_weights`` steps 1-3 shared by the plain version and the
    model path's column statistics.  Scalars are float32 tensors (0-dim or
    broadcastable)."""
    tp = g_ap + torch.clamp_min(wn, 0.0) * g_fs
    tn = g_ap + torch.clamp_min(-wn, 0.0) * g_fs
    if apply_fet:
        def fet(t):
            g_j = (t / (1.0 - r_access * t)) * g_scale
            return g_j / (1.0 + r_access * g_j)

        tp, tn = fet(tp), fet(tn)
    if use_fail:
        g_ap_b = torch.broadcast_to(g_ap, tp.shape)
        g_on_b = torch.broadcast_to(g_ap + g_fs, tp.shape)
        zero = torch.zeros((), dtype=tp.dtype, device=tp.device)
        tp = torch.where(fail_bit(fail, FAIL_POS) | fail_bit(fail, FAULT_POS_OFF),
                         g_ap_b, tp)
        tn = torch.where(fail_bit(fail, FAIL_NEG) | fail_bit(fail, FAULT_NEG_OFF),
                         g_ap_b, tn)
        tp = torch.where(fail_bit(fail, FAULT_POS_ON), g_on_b, tp)
        tn = torch.where(fail_bit(fail, FAULT_NEG_ON), g_on_b, tn)
        dead = fail_bit(fail, FAULT_DEAD)
        tp = torch.where(dead, zero, tp)
        tn = torch.where(dead, zero, tn)
    return tp, tn


def _tile_g_diff(wn, fail, aux, *, apply_fet: bool, use_fail: bool):
    """Differential conductance from the aux-plane scalars (column 0 of the
    broadcast rows) and the per-column attenuation rows."""
    tp, tn = pos_neg_conductance(
        wn, fail,
        aux[ROW_G_AP:ROW_G_AP + 1, :1],
        aux[ROW_G_FS:ROW_G_FS + 1, :1],
        aux[ROW_G_SCALE:ROW_G_SCALE + 1, :1],
        aux[ROW_R_ACCESS:ROW_R_ACCESS + 1, :1],
        apply_fet=apply_fet, use_fail=use_fail)
    att_p = aux[ROW_ATT_POS:ROW_ATT_POS + 1, :]
    att_n = aux[ROW_ATT_NEG:ROW_ATT_NEG + 1, :]
    return att_p * tp - att_n * tn


def fake_analog_kernel(v: torch.Tensor, wn: torch.Tensor, fail: torch.Tensor,
                       aux: torch.Tensor, adc_bits: int = 0,
                       apply_fet: bool = False,
                       use_fail: bool = False) -> torch.Tensor:
    """(M, K) voltages x (K, N) normalized weights / fail codes + (8, N) aux
    -> (M, N) float32 decoded output (signature of the reference's
    ``fake_analog_mac_pallas``)."""
    M, K, N = analog_mac.gemm_shapes("fake_analog", v, wn)
    if fail.shape != wn.shape or aux.shape != (AUX_ROWS, N):
        raise ValueError(f"fake_analog: fail {tuple(fail.shape)} must match "
                         f"wn {tuple(wn.shape)}, aux must be ({AUX_ROWS}, "
                         f"{N}), got {tuple(aux.shape)}")
    assert adc_bits == 0 or adc_bits >= 2, adc_bits
    if v.is_cpu:
        return ref_fake_analog(v, wn, fail, aux, adc_bits, apply_fet,
                               use_fail)
    index = analog_mac.cuda_index("fake_analog", v, wn, fail, aux)
    v, wn, fail, aux = (analog_mac.f32(t) for t in (v, wn, fail, aux))
    out = torch.empty((M, N), dtype=torch.float32, device=v.device)
    if M and N:
        lib, splits, ws = analog_mac.plan("fake_analog", M, K, N, v,
                                          split_tile=SPLIT_TILE)
        vec = N % 4 == 0 and analog_mac.aligned(wn, fail)
        analog_mac.launch("fake_analog", lib.fake_analog_launch, index,
                          v.data_ptr(), wn.data_ptr(), fail.data_ptr(),
                          aux.data_ptr(), out.data_ptr(),
                          analog_mac.ptr(ws), M, K, N, splits, int(vec),
                          int(adc_bits), int(bool(apply_fet)),
                          int(bool(use_fail)))
        analog_mac.count(fake_analog_kernel, M, K, N, splits)
    return out


analog_mac.reset_counts(fake_analog_kernel)
