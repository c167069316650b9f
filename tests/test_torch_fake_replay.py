"""The fake-analog kernel's replay arithmetic, mirrored in plain PyTorch and
held bit-equal to the plain version on the CPU.

``csrc/fake_analog.cu`` rewrites two pieces of ``pos_neg_conductance`` /
``_tile_g_diff`` (``kernels/fake_analog.py``) without changing a bit:

- the fail decode on integers: bit j of ``(int)floorf(code)`` (two's
  complement) for codes in [-2^31, 2^31), no bit otherwise, against
  ``fail_bit``'s ``floor(code * 2^-j) mod 2 >= 1`` (a floored mod, as the
  reference's ``jnp.mod``);
- one FET round trip per element: the side without weight (wn > 0: tn,
  wn < 0: tp, wn == 0: both) is G_AP, or fet(G_AP) computed once; without
  fail codes g_diff is ``m * t + c`` with per-column (m, c) picked by the
  sign of wn.

The mirrors below compute what the kernel computes, operation for
operation (float32, each product and sum rounded on its own); the kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fake_analog as fa

F32 = torch.float32
BITS = (fa.FAIL_POS, fa.FAIL_NEG, fa.FAULT_POS_OFF, fa.FAULT_NEG_OFF,
        fa.FAULT_POS_ON, fa.FAULT_NEG_ON, fa.FAULT_DEAD)


def kernel_fail_bits(code: torch.Tensor) -> torch.Tensor:
    """``fail_bits`` of csrc/fake_analog.cu: (int)floorf(code) for codes in
    [-2^31, 2^31), else 0 (int64; its bits 0-6 are the int32's)."""
    ok = (code >= -2147483648.0) & (code < 2147483648.0)
    safe = torch.where(ok, code, torch.zeros((), dtype=F32))
    return torch.where(ok, torch.floor(safe).to(torch.int64),
                       torch.zeros((), dtype=torch.int64))


def _codes() -> torch.Tensor:
    j = torch.arange(8192, dtype=F32)
    specials = torch.tensor(
        [-0.0, float("nan"), float("inf"), -float("inf"), -1.0, -0.5,
         -127.0, -1e-45, 1e-45, 2.0 ** 24, 2.0 ** 24 + 2, 2.0 ** 25 + 4,
         2.0 ** 31 - 128, 2.0 ** 31, 2.0 ** 32, 3e38, 127.99999,
         -2.0 ** 31, -2.0 ** 31 + 128, -2.0 ** 31 - 256, -2.0 ** 24 - 2,
         -3e38],
        dtype=F32)
    return torch.cat([j / 64,                            # 0 .. 127.98
                      torch.arange(128 * 64, 256 * 64, dtype=F32) / 64,
                      -j / 64, specials])


@pytest.mark.parametrize("bit", BITS)
def test_integer_fail_decode_equals_fail_bit(bit):
    """Equal on every code but the negative subnormals, where fail_bit's
    product code * 2^-j underflows to -0 (no bit) while floor(code) is -1
    (every bit): far outside the codes 0 .. FAIL_CODE_MAX any plane holds."""
    code = _codes()
    assert code.dtype == F32
    want = fa.fail_bit(code, bit)
    got = (kernel_fail_bits(code) & bit) != 0
    tiny = (code < 0) & (code > -torch.finfo(F32).tiny)
    assert int(tiny.sum()) == 1
    assert torch.equal(got[~tiny], want[~tiny])
    assert bool(got[tiny].all())


def test_integer_fail_decode_covers_the_contract():
    """Every code 0 .. FAIL_CODE_MAX decodes to its own bits."""
    code = torch.arange(fa.FAIL_CODE_MAX + 1, dtype=F32)
    assert torch.equal(kernel_fail_bits(code), torch.arange(
        fa.FAIL_CODE_MAX + 1))


def _fet(t, r_access, g_scale):
    g_j = (t / (1.0 - r_access * t)) * g_scale
    return g_j / (1.0 + r_access * g_j)


def kernel_pos_neg(wn, fail, g_ap, g_fs, g_scale, r_access, *,
                   apply_fet: bool, use_fail: bool):
    """(tp, tn) as the kernel's producer computes them: one round trip per
    element on the weighted side's target, the other side fet(G_AP) from
    once per block."""
    fa_ = _fet(g_ap, r_access, g_scale) if apply_fet else g_ap
    t = g_ap + torch.abs(wn) * g_fs
    if apply_fet:
        t = _fet(t, r_access, g_scale)
    tp = torch.where(wn > 0.0, t, fa_)
    tn = torch.where(wn < 0.0, t, fa_)
    if use_fail:
        bits = kernel_fail_bits(fail)
        g_on = g_ap + g_fs
        zero = torch.zeros((), dtype=F32)
        tp = torch.where((bits & (fa.FAIL_POS | fa.FAULT_POS_OFF)) != 0,
                         g_ap, tp)
        tn = torch.where((bits & (fa.FAIL_NEG | fa.FAULT_NEG_OFF)) != 0,
                         g_ap, tn)
        tp = torch.where((bits & fa.FAULT_POS_ON) != 0, g_on, tp)
        tn = torch.where((bits & fa.FAULT_NEG_ON) != 0, g_on, tn)
        dead = (bits & fa.FAULT_DEAD) != 0
        tp = torch.where(dead, zero, tp)
        tn = torch.where(dead, zero, tn)
    return tp, tn


def kernel_g_diff(wn, fail, aux, *, apply_fet: bool, use_fail: bool):
    """g_diff as the kernel's producer writes it (its constants from the
    aux plane as ``_tile_g_diff`` reads them)."""
    s = {name: aux[row:row + 1, :1] for name, row in (
        ("g_ap", fa.ROW_G_AP), ("g_fs", fa.ROW_G_FS),
        ("g_scale", fa.ROW_G_SCALE), ("r_access", fa.ROW_R_ACCESS))}
    att_p = aux[fa.ROW_ATT_POS:fa.ROW_ATT_POS + 1, :]
    att_n = aux[fa.ROW_ATT_NEG:fa.ROW_ATT_NEG + 1, :]
    if use_fail:
        tp, tn = kernel_pos_neg(wn, fail, **s, apply_fet=apply_fet,
                                use_fail=True)
        return att_p * tp - att_n * tn
    fa_ = (_fet(s["g_ap"], s["r_access"], s["g_scale"]) if apply_fet
           else s["g_ap"])
    t = s["g_ap"] + torch.abs(wn) * s["g_fs"]
    if apply_fet:
        t = _fet(t, s["r_access"], s["g_scale"])
    pos = wn > 0.0
    m = torch.where(pos, att_p, -att_n)
    c = torch.where(pos, -(att_n * fa_), att_p * fa_)
    return m * t + c


def _operands(k: int, n: int, seed: int, zeros: float = 0.1):
    """Normalized weights with exact +0.0 and -0.0, fail codes 0..127, an
    aux plane of the model path's magnitudes (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    wn = np.tanh(rng.standard_normal((k, n))).astype(np.float32)
    wn[rng.random((k, n)) < zeros] = 0.0
    wn[rng.random((k, n)) < zeros] = -0.0
    fail = rng.integers(0, fa.FAIL_CODE_MAX + 1, (k, n)).astype(np.float32)
    fail[rng.random((k, n)) < 0.5] = 0.0
    aux = np.zeros((fa.AUX_ROWS, n), np.float32)
    aux[fa.ROW_ATT_POS] = 0.9 + 0.1 * rng.random(n)
    aux[fa.ROW_ATT_NEG] = 0.9 + 0.1 * rng.random(n)
    aux[fa.ROW_I_MAX] = 2e-3
    aux[fa.ROW_DECODE] = 1234.5
    aux[fa.ROW_G_AP] = 1.6e-4 * (1 + rng.random())
    aux[fa.ROW_G_FS] = 4.1e-4 * (1 + rng.random())
    aux[fa.ROW_G_SCALE] = 0.9 + 0.2 * rng.random()
    aux[fa.ROW_R_ACCESS] = 1e3 * (1 + rng.random())
    return torch.from_numpy(wn), torch.from_numpy(fail), torch.from_numpy(aux)


@pytest.mark.parametrize("apply_fet", [False, True])
@pytest.mark.parametrize("use_fail", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_fet_per_element_equals_pos_neg_conductance(apply_fet, use_fail,
                                                        seed):
    wn, fail, aux = _operands(96, 130, seed)
    assert bool((torch.signbit(wn) & (wn == 0)).any())      # -0.0 present
    assert bool((~torch.signbit(wn) & (wn == 0)).any())     # +0.0 present
    s = dict(g_ap=aux[fa.ROW_G_AP:fa.ROW_G_AP + 1, :1],
             g_fs=aux[fa.ROW_G_FS:fa.ROW_G_FS + 1, :1],
             g_scale=aux[fa.ROW_G_SCALE:fa.ROW_G_SCALE + 1, :1],
             r_access=aux[fa.ROW_R_ACCESS:fa.ROW_R_ACCESS + 1, :1])
    kw = dict(apply_fet=apply_fet, use_fail=use_fail)
    tp, tn = fa.pos_neg_conductance(wn, fail, **s, **kw)
    ktp, ktn = kernel_pos_neg(wn, fail, **s, **kw)
    assert torch.equal(ktp, tp) and torch.equal(ktn, tn)


@pytest.mark.parametrize("apply_fet", [False, True])
@pytest.mark.parametrize("use_fail", [False, True])
@pytest.mark.parametrize("seed", [2, 3])
def test_kernel_g_diff_equals_tile_g_diff(apply_fet, use_fail, seed):
    """The tile the consumers read, bit for bit (signs of zero included)."""
    wn, fail, aux = _operands(80, 200, seed)
    kw = dict(apply_fet=apply_fet, use_fail=use_fail)
    want = fa._tile_g_diff(wn, fail, aux, **kw)
    got = kernel_g_diff(wn, fail, aux, **kw)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
