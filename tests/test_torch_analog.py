"""The port's analog MAC kernels (plain versions on the CPU) and the analog
read path against the JAX reference, on shared numpy-seeded inputs.

Tolerances are the reference's own:

* bit-line MAC without ADC: rtol 1e-5, atol 1e-8 (``tests/test_kernels.py``);
  with the ADC at most 1 LSB, on under 1% of elements (a float-ulp
  difference in the sum can land on a bin edge);
* XNOR GEMM: exact, float32 and bfloat16, both tie conventions;
* fake-analog MVM vs its oracle: rtol 1e-6, atol 1e-6 x decode gain;
* programming / analog_matmul / fake_analog_matmul / binary_matmul vs the
  reference: the parity tolerances of ``tests/test_analog_pipeline.py``
  (rtol 1e-5, atol 1e-5 x max|y|).  Sums run in another order on each
  side (XLA:CPU vs PyTorch), so conductances and column statistics differ
  by float32 ulps (measured: g_diff within 8.2e-7 of max|g_diff|, decoded
  outputs within 3.6e-7 of max|y|).

The reference's ``jax.random`` draws (write-BER masks, decode-projection
draws) are handed to the port by replacing ``write_ber_masks`` /
``projection_draws``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.core.params import PROCESS_CORNERS as J_CORNERS
from repro.core.params import VariationSpec as JVariationSpec
from repro.imc import analog_pipeline as jap
from repro.imc import mapping as jmapping
from repro.imc.model_analog import fake_analog_matmul as j_fake_matmul
from repro.kernels import ref as jref
from repro.kernels.bitline_mac import adc_quantize as j_adc
from repro_torch.configs.registry import get_arch
from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import mapping as tmapping
from repro_torch.imc.model_analog import fake_analog_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels import fake_analog as tfa
from repro_torch.kernels.bitline_mac import adc_quantize

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _jax_ber_masks(seed, ber, shape, device):
    """The reference's write-BER draw (``analog_pipeline.py:209``)."""
    kber = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EB)
    kb1, kb2 = jax.random.split(kber)
    shape = tuple(shape)
    return (_t(jax.random.bernoulli(kb1, ber, shape)).to(device),
            _t(jax.random.bernoulli(kb2, ber, shape)).to(device))


@pytest.fixture
def shared_ber(monkeypatch):
    monkeypatch.setattr(tap, "write_ber_masks", _jax_ber_masks)


def _wx(k=200, n=150, m=7, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / k**0.5).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return w, x


# --- B3: bit-line MAC ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 256)])
@pytest.mark.parametrize("adc_bits", [0, 4, 8])
def test_bitline_mac_plain_matches_reference(shape, adc_bits):
    m, k, n = shape
    rng = np.random.default_rng(0)
    v = rng.uniform(size=(m, k)).astype(np.float32)
    g = (rng.uniform(size=(k, n)) * 3.4e-4).astype(np.float32)
    out_t = _np(ops.bitline_mac(_t(v), _t(g), adc_bits, i_max=0.05))
    out_r = np.asarray(jref.ref_bitline_mac(jnp.asarray(v), jnp.asarray(g),
                                            adc_bits, i_max=0.05))
    if adc_bits == 0:
        np.testing.assert_allclose(out_t, out_r, rtol=1e-5, atol=1e-8)
    else:
        lsb = 0.05 / (2 ** (adc_bits - 1) - 1)
        diff = np.abs(out_t - out_r)
        assert diff.max() <= lsb * 1.001, diff.max()
        assert (diff > lsb * 1e-3).mean() < 0.01


# the reference tests' odd shapes, then the split-K edges of the CUDA
# kernels: K below the unclamped split x BK, K not a multiple of the stage
# depth, M = 1 with a deep split
EDGE_SHAPES = [(3, 200, 77), (65, 130, 190), (1, 1, 1), (129, 127, 128),
               (1, 20, 77), (2, 100, 190), (1, 600, 96)]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_bitline_mac_odd_shapes(shape):
    m, k, n = shape
    rng = np.random.default_rng(1)
    v = rng.standard_normal((m, k)).astype(np.float32)
    g = (rng.standard_normal((k, n)) * 3.4e-4).astype(np.float32)
    out_t = _np(ops.bitline_mac(_t(v), _t(g)))
    out_r = np.asarray(jref.ref_bitline_mac(jnp.asarray(v), jnp.asarray(g)))
    assert out_t.shape == (m, n)
    np.testing.assert_allclose(out_t, out_r, rtol=1e-5, atol=1e-8)


def test_adc_signed_and_symmetric():
    """Signed currents pass the ADC (regression for clip(0, 1)), the
    quantizer is odd, and it equals the reference's on a ramp (exact)."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((16, 128)).astype(np.float32)
    g = (rng.standard_normal((128, 32)) * 1e-4).astype(np.float32)
    out = _np(ops.bitline_mac(_t(v), _t(g), adc_bits=6, i_max=2e-3))
    ideal = v @ g
    neg = ideal < -1e-4
    assert neg.any() and np.mean(np.sign(out[neg]) == -1) > 0.99
    i = torch.linspace(0.0, 2.0, 201)
    assert torch.equal(adc_quantize(-i, 5, 1.0), -adc_quantize(i, 5, 1.0))
    np.testing.assert_array_equal(
        _np(adc_quantize(i, 5, 1.0)),
        np.asarray(j_adc(jnp.asarray(_np(i)), 5, 1.0)))


# --- B4: XNOR GEMM ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (128, 512, 256),
                                   (3, 200, 77), (130, 190, 65),
                                   *EDGE_SHAPES[4:]])
@pytest.mark.parametrize("binarize", [False, True])
@pytest.mark.parametrize("zeros", [0.0, 0.1])
def test_xnor_gemm_exact(shape, dtype, binarize, zeros):
    """+-1 operands, and with a share of 0 (the operand contract is
    {-1, 0, +1}); exact."""
    m, k, n = shape
    rng = np.random.default_rng(3)
    a = np.sign(rng.standard_normal((m, k))).astype(np.float32)
    w = np.sign(rng.standard_normal((k, n))).astype(np.float32)
    a[rng.uniform(size=a.shape) < zeros] = 0.0
    w[rng.uniform(size=w.shape) < zeros] = 0.0
    tdt = getattr(torch, dtype)
    out_t = _np(ops.xnor_gemm(_t(a).to(tdt), _t(w).to(tdt), binarize))
    out_r = np.asarray(jref.ref_xnor_gemm(
        jnp.asarray(a, getattr(jnp, dtype)), jnp.asarray(w, getattr(jnp, dtype)),
        binarize))
    assert out_t.shape == (m, n) and out_t.dtype == np.float32
    np.testing.assert_array_equal(out_t, out_r)


@pytest.mark.parametrize("tie", [1, -1])
def test_xnor_binarize_tie(tie):
    """Even-K exact ties land on the requested side, as the reference's."""
    k = 128
    a = torch.cat([torch.ones(8, k // 2), -torch.ones(8, k // 2)], 1)
    w = torch.ones(k, 16)
    out = _np(ops.xnor_gemm(a, w, binarize=True, tie=tie))
    assert (out == tie).all()
    np.testing.assert_array_equal(out, np.asarray(jref.ref_xnor_gemm(
        jnp.asarray(_np(a)), jnp.asarray(_np(w)), binarize=True, tie=tie)))


def test_xnor_popcount_identity():
    rng = np.random.default_rng(4)
    a_bits = rng.integers(0, 2, (16, 64))
    w_bits = rng.integers(0, 2, (16, 64))
    got = _np(ref.ref_xnor_popcount(_t(a_bits), _t(w_bits.T)))
    pm = lambda b: (2 * b - 1).astype(np.float32)   # noqa: E731
    np.testing.assert_array_equal(got, pm(a_bits) @ pm(w_bits).T)
    np.testing.assert_array_equal(got, np.asarray(jref.ref_xnor_popcount(
        jnp.asarray(a_bits), jnp.asarray(w_bits.T))))


# --- B5: fake-analog MVM ------------------------------------------------------

def _fake_operands(seed, max_code, shape=(5, 150, 70)):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    v = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    wn = np.tanh(rng.standard_normal((k, n))).astype(np.float32)
    fail = rng.integers(0, max_code + 1, (k, n)).astype(np.float32)
    aux = np.zeros((tfa.AUX_ROWS, n), np.float32)
    aux[tfa.ROW_ATT_POS] = 0.9 + 0.1 * rng.uniform(size=n)
    aux[tfa.ROW_ATT_NEG] = 0.9 + 0.1 * rng.uniform(size=n)
    aux[tfa.ROW_I_MAX] = 2e-3
    aux[tfa.ROW_DECODE] = 1234.5
    aux[tfa.ROW_G_AP] = 2e-4
    aux[tfa.ROW_G_FS] = 3e-4
    aux[tfa.ROW_G_SCALE] = 1.05
    aux[tfa.ROW_R_ACCESS] = 1e3
    return v, wn, fail, aux


@pytest.mark.parametrize("max_code", [3, tfa.FAIL_CODE_MAX])
@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False),
                                   (False, False)])
@pytest.mark.parametrize("shape", [(5, 150, 70), *EDGE_SHAPES[4:]])
def test_fake_analog_plain_matches_reference(max_code, flags, shape):
    """FET round trip and the fail/fault decode (write-verify codes and the
    full 7-bit alphabet) against the reference's oracle."""
    apply_fet, use_fail = flags
    v, wn, fail, aux = _fake_operands(9, max_code, shape)
    kw = dict(adc_bits=5, apply_fet=apply_fet, use_fail=use_fail)
    out_t = _np(tfa.fake_analog_kernel(_t(v), _t(wn), _t(fail), _t(aux), **kw))
    out_r = np.asarray(jref.ref_fake_analog(
        jnp.asarray(v), jnp.asarray(wn), jnp.asarray(fail), jnp.asarray(aux),
        **kw))
    assert out_t.shape == (shape[0], shape[2])
    np.testing.assert_allclose(out_t, out_r, rtol=1e-6, atol=1e-6 * 1234.5)


def test_fail_bit_and_conductance_decode_equal():
    """The per-cell decode is elementwise float32: bit-equal."""
    from repro.kernels.fake_analog import _tile_g_diff as j_tile

    v, wn, fail, aux = _fake_operands(10, tfa.FAIL_CODE_MAX)
    for bit in (1, 2, 4, 8, 16, 32, 64):
        from repro.kernels.fake_analog import fail_bit as j_fail_bit
        np.testing.assert_array_equal(
            _np(tfa.fail_bit(_t(fail), bit)),
            np.asarray(j_fail_bit(jnp.asarray(fail), bit)))
    g_t = _np(tfa._tile_g_diff(_t(wn), _t(fail), _t(aux), apply_fet=True,
                               use_fail=True))
    g_r = np.asarray(j_tile(jnp.asarray(wn), jnp.asarray(fail),
                            jnp.asarray(aux), apply_fet=True, use_fail=True))
    np.testing.assert_allclose(g_t, g_r, rtol=2e-7, atol=0)


# --- programming and the analog MVM vs the reference --------------------------

CONFIGS = {
    "ideal": dict(adc_bits=0, ir_drop=False),
    "adc6": dict(adc_bits=6),
    "tmr5_adc8": dict(adc_bits=8, tmr=5.0),
    "write_ber": dict(adc_bits=6, write_ber=0.02, seed=3),
    "ss": dict(adc_bits=6, corner="ss"),
    "ff": dict(adc_bits=6, corner="ff"),
    "g_sigma": dict(adc_bits=8, tmr=5.0, d2d=0.05),
}


def _cfg_pair(name):
    kw = dict(CONFIGS[name])
    corner, d2d = kw.pop("corner", None), kw.pop("d2d", None)
    jkw, tkw = dict(kw), dict(kw)
    if corner is not None:
        jkw["variation"] = JVariationSpec(corners=(J_CORNERS[corner],))
        tkw["variation"] = VariationSpec(corners=(PROCESS_CORNERS[corner],))
    if d2d is not None:
        jkw["variation"] = JVariationSpec.from_g_sigma(d2d, seed=1)
        tkw["variation"] = VariationSpec.from_g_sigma(d2d, seed=1)
    return jap.AnalogConfig(**jkw), tap.AnalogConfig(**tkw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_program_and_analog_matmul_match_reference(name, shared_ber):
    w, x = _wx(k=130, n=100, m=5, seed=7)
    jcfg, tcfg = _cfg_pair(name)
    aj = jap.program_weights(jnp.asarray(w), "afmtj", jcfg)
    at = tap.program_weights(w, "afmtj", tcfg, device=CPU)
    gj = np.asarray(aj.g_diff)
    np.testing.assert_allclose(_np(at.g_diff), gj, rtol=0,
                               atol=2e-6 * np.abs(gj).max())
    assert at.w_scale == aj.w_scale and at.g_fs == aj.g_fs
    assert at.att_mean == pytest.approx(aj.att_mean, rel=1e-6)
    assert at.g_rms == pytest.approx(aj.g_rms, rel=1e-6)
    _, im_j, xs_j = jap.kernel_operands(aj, jnp.asarray(x))
    _, im_t, xs_t = tap.kernel_operands(at, x)
    assert (im_t, xs_t) == (im_j, xs_j)
    yj = np.asarray(jap.analog_matmul(aj, jnp.asarray(x)))
    yt = _np(tap.analog_matmul(at, _t(x)))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("name", ["adc6", "tmr5_adc8", "write_ber", "ss",
                                  "ff"])
def test_fake_analog_matmul_matches_reference(name, shared_ber):
    """Explicit ADC full scale (the device path's) and the fake path's own
    2-significant-digit sizing, against the reference's fake path."""
    w, x = _wx(k=130, n=100, m=5, seed=8)
    jcfg, tcfg = _cfg_pair(name)
    _, i_max, _ = jap.kernel_operands(jap.program_weights(jnp.asarray(w),
                                                          "afmtj", jcfg),
                                      jnp.asarray(x))
    for im in (i_max, None):
        yj = np.asarray(j_fake_matmul(jnp.asarray(w), jnp.asarray(x),
                                      cfg=jcfg, i_max=im, interpret=True))
        yt = _np(fake_analog_matmul(w, x, cfg=tcfg, i_max=im, device=CPU))
        np.testing.assert_allclose(yt, yj, rtol=1e-5,
                                   atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("shape", [(5, 200, 77), (3, 130, 190)])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_port_fake_vs_device_parity(shape, bits):
    """Within the port: the fused path equals the programming chain to the
    reference's bound (same ADC full scale fed to both)."""
    m, k, n = shape
    w, x = _wx(k=k, n=n, m=m, seed=bits)
    cfg = tap.AnalogConfig(adc_bits=bits)
    arr = tap.program_weights(w, "afmtj", cfg, device=CPU)
    _, i_max, _ = tap.kernel_operands(arr, x)
    y_dev = _np(tap.analog_matmul(arr, _t(x)))
    y_fake = _np(fake_analog_matmul(w, x, cfg=cfg, i_max=i_max, device=CPU))
    np.testing.assert_allclose(y_fake, y_dev, rtol=1e-5,
                               atol=1e-5 * np.abs(y_dev).max())
    # sizing its own full scale and decode gain as the device path does,
    # the fused path equals it bit for bit
    y_own = _np(fake_analog_matmul(w, x, cfg=cfg, device=CPU))
    np.testing.assert_array_equal(y_own, y_dev)


def test_port_raw_currents_bit_equal():
    """The reference's acceptance pin on the port: at zero IR drop with a
    shared ADC full scale, the fused path's quantized bit-line currents are
    bit-equal to the bit-line MAC's on the programmed g_diff."""
    w, x = _wx()
    cfg = tap.AnalogConfig(adc_bits=6, ir_drop=False)
    arr = tap.program_weights(w, "afmtj", cfg, device=CPU)
    v, i_max, _ = tap.kernel_operands(arr, x)
    i_dev = ops.bitline_mac(v, arr.g_diff, 6, i_max=i_max)
    i_fake = fake_analog_matmul(w, x, cfg=cfg, i_max=i_max, decode=False,
                                device=CPU)
    assert torch.equal(i_fake, i_dev)


def test_port_fake_d2d_raises():
    w, x = _wx(k=64, n=32, m=2)
    cfg = tap.AnalogConfig(adc_bits=6,
                           variation=VariationSpec.from_g_sigma(0.05))
    with pytest.raises(NotImplementedError):
        fake_analog_matmul(w, x, cfg=cfg, device=CPU)


@pytest.mark.parametrize("tie", [1, -1])
def test_binary_matmul_matches_reference(tie):
    w, x = _wx()
    yj = np.asarray(jap.binary_matmul(jnp.asarray(x), jnp.asarray(w), tie=tie))
    yt = _np(tap.binary_matmul(x, w, tie=tie, device=CPU))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("mode", ["analog", "bnn"])
def test_mvm_accuracy_matches_reference(mode):
    w, x = _wx()
    cfg_j, cfg_t = jap.AnalogConfig(adc_bits=6), tap.AnalogConfig(adc_bits=6)
    rj = jap.mvm_accuracy(jnp.asarray(w), jnp.asarray(x), cfg=cfg_j, mode=mode)
    rt = tap.mvm_accuracy(w, x, cfg=cfg_t, mode=mode, device=CPU)
    assert (rt.m, rt.k, rt.n, rt.mode, rt.tmr) == (rj.m, rj.k, rj.n, rj.mode,
                                                   rj.tmr)
    assert rt.nmse == pytest.approx(rj.nmse, rel=1e-4)
    assert rt.cosine == pytest.approx(rj.cosine, rel=1e-6)


def test_accuracy_surface_matches_reference(monkeypatch):
    """``mapping.accuracy_surface`` on the reference's projection draws."""
    def draws(seed, k, n, batch):
        kw, kx = jax.random.split(jax.random.PRNGKey(seed))
        w = jax.random.normal(kw, (k, n), jnp.float32) / (k ** 0.5)
        x = jax.random.normal(kx, (batch, k), jnp.float32)
        return _t(w), _t(x)

    monkeypatch.setattr(tmapping, "projection_draws", draws)
    kw = dict(adc_bits=(4, 8), tmrs=(0.8,), cap_k=128, cap_n=64, batch=4)
    sj = jmapping.accuracy_surface(J_ARCHS["qwen2-0.5b"], **kw)
    st = tmapping.accuracy_surface(get_arch("qwen2-0.5b"), device=CPU, **kw)
    assert set(st) == set(sj) == {(4, 0.8), (8, 0.8)}
    for key in sj:
        assert st[key].arch == "qwen2-0.5b"
        assert st[key].nmse == pytest.approx(sj[key].nmse, rel=1e-3)
        assert st[key].cosine == pytest.approx(sj[key].cosine, rel=1e-6)
    assert tmapping.decode_projection_shapes(get_arch("qwen2-0.5b")) == \
        jmapping.decode_projection_shapes(J_ARCHS["qwen2-0.5b"])


def test_wrappers_reject_other_devices():
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel

    meta = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError):
        bitline_mac_kernel(meta, meta)
    with pytest.raises(ValueError):
        xnor_gemm_kernel(meta, meta)
    with pytest.raises(ValueError):
        tfa.fake_analog_kernel(meta, meta, meta, torch.zeros(8, 4, device="meta"))
    with pytest.raises(ValueError):
        bitline_mac_kernel(torch.zeros(3, 4), torch.zeros(5, 4))


def test_cpu_calls_do_not_count_launches():
    from repro_torch.kernels.bitline_mac import bitline_mac_kernel
    from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel

    before = (bitline_mac_kernel.launches, xnor_gemm_kernel.launches,
              tfa.fake_analog_kernel.launches)
    w, x = _wx(k=32, n=16, m=2)
    fake_analog_matmul(w, x, device=CPU)
    tap.analog_matmul(tap.program_weights(w, device=CPU), _t(x))
    tap.binary_matmul(x, w, device=CPU)
    assert (bitline_mac_kernel.launches, xnor_gemm_kernel.launches,
            tfa.fake_analog_kernel.launches) == before
    assert dataclasses.is_dataclass(tap.AnalogConfig())
