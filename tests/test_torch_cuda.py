"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without them they skip.  On a machine with both:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Bounds: the LLG kernel, the reference's kernel-vs-oracle bound, rows 0-5
within atol 2e-5 and row 7 equal (the kernel follows the plain version
operation by operation, so both are usually bit-identical).  The analog MAC
kernels (``csrc/analog_mac.cu``): bit-line MAC rtol 1e-5 / atol 1e-8 without
ADC, at most 1 LSB on under 1% of elements with it; XNOR exact; fake-analog
rtol 1e-6 / atol 1e-6 x decode gain, and its raw currents bit-equal to the
bit-line kernel's on the same g_diff.
"""
import math

import pytest
import torch

from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.kernels import fake_analog as fa
from repro_torch.kernels import noise, ref
from repro_torch.kernels.bitline_mac import bitline_mac_kernel
from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
from repro_torch.kernels.xnor_gemm import xnor_gemm_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _states(p, cells, vlo, vhi, dev):
    gen = torch.Generator().manual_seed(5)
    th = torch.rand(cells, generator=gen) * 0.35 + 0.05
    ph = torch.rand(cells, generator=gen) * 2 * math.pi
    m1 = torch.stack([th.sin() * ph.cos(), th.sin() * ph.sin(), th.cos()])
    s = torch.zeros(8, cells)
    s[0:3] = m1
    if p.n_sublattices == 2:
        s[3:6] = -m1
    s[6] = torch.linspace(vlo, vhi, cells)
    return s.to(dev)


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
@pytest.mark.parametrize("case", ["det", "chunk0", "chunk64", "variation"])
def test_kernel_matches_plain_version(dev, kind, case):
    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    dt, n, v = ((0.1e-12, 800, (0.6, 2.0)) if kind == "afmtj"
                else (0.2e-12, 1500, (2.0, 5.0)))
    cells = 1024
    st = _states(p, cells, *v, dev)
    kw = {}
    if case != "det":
        lane = torch.arange(cells, device=dev)
        budget = torch.where(lane % 5 == 0, float(n // 3), float(n))
        kw = dict(thermal_sigma=thermal_sigma(p, dt), seeds=noise.cell_seeds(
            3, cells, dev), step_budget=budget.float(),
            chunk=0 if case == "chunk0" else 64)
        if case == "variation":
            kw["lane_params"] = torch.stack([
                torch.full((cells,), p.alpha, device=dev) * 1.1,
                torch.full((cells,), p.b_aniso, device=dev) * 0.95,
                torch.full((cells,), 1.05, device=dev)])
    before = llg_rk4_kernel.launches
    out = llg_rk4_kernel(st, p, dt, n, **kw)
    torch.cuda.synchronize()
    assert llg_rk4_kernel.launches == before + 1
    plain = ref.ref_llg_rk4(st, p, dt, n, **kw)
    torch.testing.assert_close(out[:6], plain[:6], rtol=0, atol=2e-5)
    assert torch.equal(out[6:], plain[6:])


def test_kernel_rejects_bad_shapes(dev):
    st = torch.zeros(8, 500, device=dev)
    with pytest.raises(ValueError):
        llg_rk4_kernel(st, AFMTJ_PARAMS, 1e-13, 10)


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


SHAPES = [(3, 200, 77), (65, 130, 190), (1, 1, 1), (129, 127, 128),
          (128, 896, 128), (128, 896, 896)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("adc_bits", [0, 4, 8])
def test_bitline_mac_matches_plain(dev, no_tf32, shape, adc_bits):
    m, k, n = shape
    gen = torch.Generator().manual_seed(0)
    v = torch.rand(m, k, generator=gen).to(dev)
    g = (torch.rand(k, n, generator=gen) * 3.4e-4).to(dev)
    i_max = 0.05 * max(k, 1) / 384
    before = bitline_mac_kernel.launches
    out = bitline_mac_kernel(v, g, adc_bits, i_max)
    torch.cuda.synchronize()
    assert bitline_mac_kernel.launches == before + 1
    plain = ref.ref_bitline_mac(v, g, adc_bits, i_max)
    if adc_bits == 0:
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-8)
    else:
        lsb = i_max / (2 ** (adc_bits - 1) - 1)
        diff = (out - plain).abs()
        assert diff.max().item() <= lsb * 1.001
        assert (diff > lsb * 1e-3).float().mean().item() < 0.01


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binarize,tie", [(False, 1), (True, 1), (True, -1)])
def test_xnor_gemm_exact(dev, shape, dtype, binarize, tie):
    m, k, n = shape
    gen = torch.Generator().manual_seed(1)
    a = torch.sign(torch.randn(m, k, generator=gen)).to(dev, dtype)
    w = torch.sign(torch.randn(k, n, generator=gen)).to(dev, dtype)
    out = xnor_gemm_kernel(a, w, binarize, tie)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.ref_xnor_gemm(a, w, binarize, tie))


def _fake_operands(m, k, n, dev, max_code=fa.FAIL_CODE_MAX):
    gen = torch.Generator().manual_seed(2)
    v = torch.randn(m, k, generator=gen) * 0.1
    wn = torch.tanh(torch.randn(k, n, generator=gen))
    fail = torch.randint(0, max_code + 1, (k, n), generator=gen).float()
    aux = torch.zeros(fa.AUX_ROWS, n)
    aux[fa.ROW_ATT_POS] = 0.9 + 0.1 * torch.rand(n, generator=gen)
    aux[fa.ROW_ATT_NEG] = 0.9 + 0.1 * torch.rand(n, generator=gen)
    aux[fa.ROW_I_MAX] = 2e-3 * max(k, 1) / 150
    aux[fa.ROW_DECODE] = 1234.5
    aux[fa.ROW_G_AP] = 2e-4
    aux[fa.ROW_G_FS] = 3e-4
    aux[fa.ROW_G_SCALE] = 1.05
    aux[fa.ROW_R_ACCESS] = 1e3
    return [t.to(dev) for t in (v, wn, fail, aux)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False),
                                   (False, False)])
def test_fake_analog_matches_plain(dev, no_tf32, shape, flags):
    apply_fet, use_fail = flags
    v, wn, fail, aux = _fake_operands(*shape, dev)
    kw = dict(adc_bits=5, apply_fet=apply_fet, use_fail=use_fail)
    out = fa.fake_analog_kernel(v, wn, fail, aux, **kw)
    torch.cuda.synchronize()
    plain = ref.ref_fake_analog(v, wn, fail, aux, **kw)
    lsb = 1234.5 * aux[fa.ROW_I_MAX, 0].item() / 15
    diff = (out - plain).abs()
    close = diff <= 1e-6 * plain.abs() + 1e-6 * 1234.5
    # a float-ulp difference in the sum may land on an ADC bin edge
    assert diff.max().item() <= lsb * 1.001
    assert (~close).float().mean().item() < 0.01


def test_fake_raw_currents_bit_equal_to_bitline(dev):
    """att = 1, decode = 1: the fused kernel's quantized currents equal the
    bit-line kernel's on the g_diff its prologue builds."""
    v, wn, fail, aux = _fake_operands(7, 200, 150, dev)
    aux[fa.ROW_ATT_POS] = 1.0
    aux[fa.ROW_ATT_NEG] = 1.0
    aux[fa.ROW_DECODE] = 1.0
    i_max = aux[fa.ROW_I_MAX, 0].item()
    g_diff = fa._tile_g_diff(wn, fail, aux, apply_fet=True, use_fail=True)
    i_fake = fa.fake_analog_kernel(v, wn, fail, aux, 6, True, True)
    i_mac = bitline_mac_kernel(v, g_diff, 6, i_max)
    torch.cuda.synchronize()
    assert torch.equal(i_fake, i_mac)
