"""The CUDA kernels against their plain PyTorch versions, on the card, and
the entry points of chip_smoke.py phase 8 at small sizes.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without them they skip.  On a machine with both:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Bounds: the LLG kernel, the reference's kernel-vs-oracle bound, rows 0-5
within atol 2e-5 and row 7 equal (the kernel follows the plain version
operation by operation, so both are usually bit-identical); in every
layout (C blocks per exit group x T threads per lane x P noise
producers), bit-identical.  The analog GEMM
kernels (``csrc/analog_mac.cu``, ``csrc/xnor_gemm.cu``,
``csrc/fake_analog.cu``): bit-line MAC rtol 1e-5 / atol 1e-8 without ADC,
at most 1 LSB on under 1% of elements with it; XNOR exact (operands in
{-1, 0, +1}, float32 and bfloat16); fake-analog rtol 1e-6 / atol 1e-6 x
decode gain (every instance: 16-byte or 4-byte copies x FET x fail plane),
and its raw currents bit-equal to the bit-line kernel's on the same g_diff
at the qwen2-0.5b shapes; split-K calls bit-equal from call to call.
"""
import math

import pytest
import torch

from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.kernels import analog_mac
from repro_torch.kernels import fake_analog as fa
from repro_torch.kernels import noise, ref
from repro_torch.kernels.bitline_mac import bitline_mac_kernel
from repro_torch.kernels.llg_rk4 import CLUSTER_SIZES, llg_rk4_kernel
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


# every valid (kind, (C, T, P)): T = 2 only for the two-sublattice AFMTJ,
# P = 1 (noise producers) only with C >= 8
LAYOUTS = [(kind, (c, t, p)) for kind in ("afmtj", "mtj")
           for c in CLUSTER_SIZES for t in (1, 2) for p in (0, 1)
           if (t == 1 or kind == "afmtj") and (p == 0 or c >= 8)]
# producers need the chunked thermal kernel
LAYOUT_CASES = [(kind, lay, case) for kind, lay in LAYOUTS
                for case in ("det", "chunk0", "chunk64", "variation")
                if lay[2] == 0 or case in ("chunk64", "variation")]
_PLAIN = {}


def _layout_case(kind, case, dev):
    """(params, dt, n, state, kwargs) of one layout case; the variation
    rows and the step budgets vary per lane."""
    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    dt, n, v = ((0.1e-12, 700, (0.6, 2.0)) if kind == "afmtj"
                else (0.2e-12, 1300, (2.0, 5.0)))
    cells = 1024
    st = _states(p, cells, *v, dev)
    if case == "det":
        return p, dt, n, st, {}
    lane = torch.arange(cells, device=dev)
    budget = torch.where(lane % 5 == 0, float(n // 3), float(n))
    budget = torch.where(lane % 97 == 0, 0.0, budget)
    kw = dict(thermal_sigma=thermal_sigma(p, dt), seeds=noise.cell_seeds(
        9, cells, dev), step_budget=budget.float(),
        chunk=0 if case == "chunk0" else 64)
    if case == "variation":
        gen = torch.Generator(device=dev).manual_seed(6)
        kw["lane_params"] = torch.stack([
            p.alpha * (0.8 + 0.4 * torch.rand(cells, generator=gen,
                                              device=dev)),
            p.b_aniso * (0.9 + 0.2 * torch.rand(cells, generator=gen,
                                                device=dev)),
            0.85 + 0.3 * torch.rand(cells, generator=gen, device=dev)])
    return p, dt, n, st, kw


@pytest.mark.parametrize("kind,layout,case", LAYOUT_CASES)
def test_every_layout_is_bit_identical(dev, kind, layout, case):
    p, dt, n, st, kw = _layout_case(kind, case, dev)
    if (kind, case) not in _PLAIN:      # one plain run for every layout
        _PLAIN[(kind, case)] = ref.ref_llg_rk4(st, p, dt, n, **kw)
    before = llg_rk4_kernel.launches
    out = llg_rk4_kernel(st, p, dt, n, **kw, layout=layout)
    torch.cuda.synchronize()
    assert llg_rk4_kernel.launches == before + 1
    assert llg_rk4_kernel.launch_layouts[(1024, p.n_sublattices, *layout,
                                          int(case == "variation"))]
    assert torch.equal(out, _PLAIN[(kind, case)])


@pytest.mark.parametrize("kind,layout", LAYOUTS)
def test_cluster_vote(dev, kind, layout):
    """Three exit groups at chunk 64: in group 0 only lane-warp 0 is live
    (all in block 0 of its cluster), group 1 is all budget-0 padding, in
    group 2 only lane-warp 15 is live (all in block C - 1).  A cluster that
    left with a live block, or a block that left its cluster early, would
    freeze live lanes or hang."""
    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    dt, n, v = ((0.1e-12, 1500, (0.6, 2.0)) if kind == "afmtj"
                else (0.2e-12, 3000, (2.0, 5.0)))
    cells = 3 * 512
    st = _states(p, cells, *v, dev)
    lane = torch.arange(cells, device=dev)
    live = (lane < 32) | ((lane >= 1024 + 15 * 32))
    kw = dict(thermal_sigma=thermal_sigma(p, dt),
              seeds=noise.cell_seeds(10, cells, dev),
              step_budget=torch.where(live, float(n), 0.0).float(), chunk=64)
    out = llg_rk4_kernel(st, p, dt, n, **kw, layout=layout)
    torch.cuda.synchronize()
    if ("vote", kind) not in _PLAIN:
        _PLAIN[("vote", kind)] = ref.ref_llg_rk4(st, p, dt, n, **kw)
    plain = _PLAIN[("vote", kind)]
    assert torch.equal(out, plain)
    assert torch.equal(out[:6, 512:1024], st[:6, 512:1024])   # padding
    assert (out[7, live] < n).any()       # live lanes ran and crossed


@pytest.mark.parametrize("layout", [(3, 1), (32, 1), (2, 2), (1, 2),
                                    (4, 1, 1), (16, 1, 1)])
def test_kernel_rejects_a_bad_layout(dev, layout):
    st = torch.zeros(8, 512, device=dev)
    before = llg_rk4_kernel.launches
    with pytest.raises(ValueError):
        llg_rk4_kernel(st, MTJ_PARAMS, 2e-13, 10, layout=layout)
    assert llg_rk4_kernel.launches == before


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# the reference tests' odd shapes; split-K edges: K below the unclamped split
# x BK (1 x 20 x 77), K not a multiple of the stage depth (2 x 100 x 190 on
# element copies, 2 x 100 x 192 on 16-byte copies), M = 1 with a deep split
# (1 x 4864 x 896); qwen2-0.5b's five full-width (K, N) at M = 128; then
# olmoe-1b-7b's attention projections and unembed and mamba2-780m's tied
# unembed (N = 50,280, not a multiple of the 128-wide tile).  The split
# shapes also hold the chunk rule: a chunk missed or summed twice would
# break the XNOR GEMM's exactness.
FAMILY_SHAPES = [(128, 2048, 2048), (128, 2048, 50304), (128, 1536, 50280)]
SHAPES = [(3, 200, 77), (65, 130, 190), (1, 1, 1), (129, 127, 128),
          (1, 20, 77), (2, 100, 190), (2, 100, 192), (1, 4864, 896),
          (128, 896, 896), (128, 896, 128), (128, 896, 4864),
          (128, 4864, 896), (128, 896, 151936)] + FAMILY_SHAPES


@pytest.mark.parametrize("shape,split", [((128, 4864, 896), True),
                                         ((128, 896, 151936), False)])
def test_counts_of_a_call(dev, shape, split):
    """One mainloop launch per call, one reduce-pass launch when K is split
    (the tile comes from the built library), and the call's shape."""
    m, k, n = shape
    n_sm = analog_mac.sm_count(torch.cuda.current_device())
    assert n_sm == torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("analog_mac", "xnor_gemm"):
        s = analog_mac.split_count(m, n, k, analog_mac.tile(name), n_sm)
        assert (s > 1) == split
    v = torch.ones(m, k, device=dev)
    g = torch.ones(k, n, device=dev)
    analog_mac.reset_counts(bitline_mac_kernel, xnor_gemm_kernel)
    bitline_mac_kernel(v, g)
    xnor_gemm_kernel(v, g)
    for kern in (bitline_mac_kernel, xnor_gemm_kernel):
        assert (kern.launches, kern.reduce_launches) == (1, int(split))
        assert kern.launch_shapes == {(m, k, n): 1}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("adc_bits", [0, 4, 8])
def test_bitline_mac_matches_plain(dev, no_tf32, shape, adc_bits):
    m, k, n = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.rand(m, k, generator=gen, device=dev)
    g = torch.rand(k, n, generator=gen, device=dev) * 3.4e-4
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


def _ternary(shape, gen, dev, zeros: float):
    """+-1 with a ``zeros`` share of 0 (the operand contract {-1, 0, +1})."""
    x = torch.sign(torch.randn(*shape, generator=gen, device=dev))
    x[torch.rand(*shape, generator=gen, device=dev) < zeros] = 0.0
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binarize,tie", [(False, 1), (True, 1), (True, -1)])
@pytest.mark.parametrize("zeros", [0.0, 0.1])
def test_xnor_gemm_exact(dev, shape, dtype, binarize, tie, zeros):
    m, k, n = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    a = _ternary((m, k), gen, dev, zeros).to(dtype)
    w = _ternary((k, n), gen, dev, zeros).to(dtype)
    before = xnor_gemm_kernel.launches
    out = xnor_gemm_kernel(a, w, binarize, tie)
    torch.cuda.synchronize()
    assert xnor_gemm_kernel.launches == before + 1
    assert torch.equal(out, ref.ref_xnor_gemm(a, w, binarize, tie))


def _fake_operands(m, k, n, dev, max_code=fa.FAIL_CODE_MAX):
    gen = torch.Generator(device=dev).manual_seed(2)
    v = torch.randn(m, k, generator=gen, device=dev) * 0.1
    wn = torch.tanh(torch.randn(k, n, generator=gen, device=dev))
    fail = torch.randint(0, max_code + 1, (k, n), generator=gen,
                         device=dev).float()
    aux = torch.zeros(fa.AUX_ROWS, n, device=dev)
    aux[fa.ROW_ATT_POS] = 0.9 + 0.1 * torch.rand(n, generator=gen, device=dev)
    aux[fa.ROW_ATT_NEG] = 0.9 + 0.1 * torch.rand(n, generator=gen, device=dev)
    aux[fa.ROW_I_MAX] = 2e-3 * max(k, 1) / 150
    aux[fa.ROW_DECODE] = 1234.5
    aux[fa.ROW_G_AP] = 2e-4
    aux[fa.ROW_G_FS] = 3e-4
    aux[fa.ROW_G_SCALE] = 1.05
    aux[fa.ROW_R_ACCESS] = 1e3
    return v, wn, fail, aux


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


@pytest.mark.parametrize("shape", [(1, 4864, 896), (128, 896, 128),
                                   (128, 896, 151936)])
def test_repeat_calls_are_bit_equal(dev, shape):
    """Split-K without atomics: every call sums in the same order."""
    m, k, n = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    v = torch.randn(m, k, generator=gen, device=dev)
    g = torch.randn(k, n, generator=gen, device=dev) * 3.4e-4
    first = bitline_mac_kernel(v, g, 0, 1.0)
    assert torch.equal(first, bitline_mac_kernel(v, g, 0, 1.0))
    ops = _fake_operands(m, k, n, dev)
    first = fa.fake_analog_kernel(*ops, 6, True, True)
    assert torch.equal(first, fa.fake_analog_kernel(*ops, 6, True, True))
    a, w = _ternary((m, k), gen, dev, 0.1), _ternary((k, n), gen, dev, 0.1)
    first = xnor_gemm_kernel(a, w)
    assert torch.equal(first, xnor_gemm_kernel(a, w))


# --- the fake-analog MVM (csrc/fake_analog.cu): every instance -------------

FLAGS = [(fet, fail) for fet in (False, True) for fail in (False, True)]


def _unaligned(t):
    """A contiguous copy of ``t`` 4 bytes off a 16-byte boundary (the
    wrapper then takes the 4-byte copy instance, VEC = false)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _hold_fake(out, plain, aux, adc_bits):
    decode = aux[fa.ROW_DECODE, 0].item()
    lsb = decode * aux[fa.ROW_I_MAX, 0].item() / (2 ** (adc_bits - 1) - 1)
    diff = (out - plain).abs()
    close = diff <= 1e-6 * plain.abs() + 1e-6 * decode
    # a float-ulp difference in the sum may land on an ADC bin edge
    assert diff.max().item() <= lsb * 1.001
    assert (~close).float().mean().item() < 0.01


@pytest.mark.parametrize("shape", SHAPES[:8])
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("vec", [True, False])
def test_fake_analog_every_instance(dev, no_tf32, shape, flags, vec):
    """All 8 instances (VEC x FET x FAIL) against the plain version at the
    odd and split-K edge shapes; VEC = false forced by operands off a
    16-byte boundary."""
    apply_fet, use_fail = flags
    v, wn, fail, aux = _fake_operands(*shape, dev)
    if not vec:
        wn, fail = _unaligned(wn), _unaligned(fail)
    assert analog_mac.aligned(wn, fail) == vec
    kw = dict(adc_bits=5, apply_fet=apply_fet, use_fail=use_fail)
    out = fa.fake_analog_kernel(v, wn, fail, aux, **kw)
    torch.cuda.synchronize()
    _hold_fake(out, ref.ref_fake_analog(v, wn, fail, aux, **kw), aux, 5)


@pytest.mark.parametrize("apply_fet", [False, True])
def test_fake_analog_decodes_codes_as_fail_bit(dev, no_tf32, apply_fet):
    """Codes outside 0 .. FAIL_CODE_MAX decode as the plain version's
    fail_bit (a floored mod): negative (normal) codes to the bits of
    floor(code) in two's complement; -0.0, NaN, infinities and codes of
    2^31 and more to none.  (Negative subnormal codes are the one
    documented difference: fail_bit's product underflows there.)"""
    m, k, n = 65, 130, 192
    v, wn, _, aux = _fake_operands(m, k, n, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    specials = torch.tensor(
        [-1.0, -0.5, -3.25, -64.0, -127.0, -1e6, -0.0, float("nan"),
         float("inf"), -float("inf"), 2.0 ** 31, 3e38, 1000.5, 127.75],
        device=dev)
    pick = torch.randint(0, len(specials), (k, n), generator=gen, device=dev)
    fail = specials[pick]
    kw = dict(adc_bits=6, apply_fet=apply_fet, use_fail=True)
    out = fa.fake_analog_kernel(v, wn, fail, aux, **kw)
    torch.cuda.synchronize()
    _hold_fake(out, ref.ref_fake_analog(v, wn, fail, aux, **kw), aux, 6)


@pytest.mark.parametrize("shape", [(7, 200, 150), (128, 896, 896),
                                   (128, 896, 128), (128, 896, 4864),
                                   (128, 4864, 896), (128, 896, 151936)]
                         + FAMILY_SHAPES)
@pytest.mark.parametrize("flags", FLAGS)
def test_fake_raw_currents_bit_equal_at_model_shapes(dev, shape, flags):
    """att = 1, decode = 1: the fused kernel's quantized currents equal the
    bit-line kernel's on the g_diff it replays, in every instance, at the
    qwen2-0.5b launch shapes (the same split-K chunks, summed in the same
    order)."""
    apply_fet, use_fail = flags
    v, wn, fail, aux = _fake_operands(*shape, dev)
    aux[fa.ROW_ATT_POS] = 1.0
    aux[fa.ROW_ATT_NEG] = 1.0
    aux[fa.ROW_DECODE] = 1.0
    i_max = aux[fa.ROW_I_MAX, 0].item()
    g_diff = fa._tile_g_diff(wn, fail, aux, apply_fet=apply_fet,
                             use_fail=use_fail)
    i_fake = fa.fake_analog_kernel(v, wn, fail, aux, 6, apply_fet, use_fail)
    i_mac = bitline_mac_kernel(v, g_diff, 6, i_max)
    torch.cuda.synchronize()
    assert torch.equal(i_fake, i_mac)


@pytest.mark.parametrize("shape", [(1, 4864, 896), (128, 896, 128),
                                   (128, 896, 151936)])
@pytest.mark.parametrize("flags", FLAGS)
def test_fake_every_instance_repeats_bit_equal(dev, shape, flags):
    """Split-K without atomics and a producer / consumer ring: every call
    sums in the same order."""
    ops = _fake_operands(*shape, dev)
    first = fa.fake_analog_kernel(*ops, 6, *flags)
    for _ in range(2):
        assert torch.equal(first, fa.fake_analog_kernel(*ops, 6, *flags))


@pytest.mark.parametrize("shape,split", [((128, 4864, 896), True),
                                         ((128, 896, 151936), False),
                                         ((128, 896, 128), True)])
def test_fake_counts_of_a_call(dev, shape, split):
    """One mainloop launch per call, one reduce-pass launch when K is split
    (by the bit-line MAC's tile), and the call's shape."""
    m, k, n = shape
    # B5's chunks are whole steps of B3's depth
    assert analog_mac.tile("fake_analog")[2] == analog_mac.tile("analog_mac")[2]
    n_sm = analog_mac.sm_count(torch.cuda.current_device())
    s = analog_mac.split_count(m, n, k, analog_mac.tile(fa.SPLIT_TILE), n_sm)
    assert (s > 1) == split
    ops = _fake_operands(m, k, n, dev)
    analog_mac.reset_counts(fa.fake_analog_kernel)
    for flags in FLAGS:
        fa.fake_analog_kernel(*ops, 6, *flags)
    kern = fa.fake_analog_kernel
    assert (kern.launches, kern.reduce_launches) == (4, 4 * int(split))
    assert kern.launch_shapes == {(m, k, n): 4}


# --- the single-junction write kernel (csrc/llg_write.cu) -------------------
# (kind, voltages, n_steps, dt, down): the quickstart's voltages at a
# horizon past the 1 V switch, high-voltage batches that switch early, and
# the reverse write; bit-identical to ref.ref_llg_write
WRITE_CASES = [("afmtj", (0.5, 0.8, 1.0, 1.2), 3000, 0.05e-12, True),
               ("mtj", (0.5, 0.8, 1.0, 1.2), 14000, 0.1e-12, True),
               ("afmtj", (2.0, 3.0, 4.0), 600, 0.1e-12, True),
               ("mtj", (4.0, 12.0, 20.0), 1200, 0.1e-12, True),
               ("afmtj", (-2.0, -4.0), 600, 0.1e-12, False),
               ("mtj", (-8.0,), 2500, 0.1e-12, False),
               ("afmtj", tuple(0.5 + 0.05 * i for i in range(37)), 400,
                0.1e-12, True)]


@pytest.mark.parametrize("kind,volts,n,dt,down", WRITE_CASES)
def test_write_kernel_bit_identical(dev, kind, volts, n, dt, down):
    from repro_torch.core import llg
    from repro_torch.kernels.llg_write import llg_write_kernel

    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    m0 = llg.initial_state(p, theta0=0.2, phi0=0.3, up=down, device=dev)
    m0 = m0.expand(len(volts), *m0.shape).contiguous()
    v = torch.tensor(volts, dtype=torch.float32, device=dev)
    before = llg_write_kernel.launches
    got = llg_write_kernel(m0, v, p, dt, n, down)
    torch.cuda.synchronize()
    assert llg_write_kernel.launches == before + 1
    want = ref.ref_llg_write(m0, v, p, dt, n, down)
    for a, b in zip(got, want):
        assert a.device == b.device and torch.equal(a, b)


def test_write_sweep_launches_once(dev):
    from repro_torch.core.device import simulate_write, write_sweep
    from repro_torch.kernels import llg_write

    llg_write.reset_counts()
    r = write_sweep(AFMTJ_PARAMS, (0.5, 1.0, 1.2), n_steps=3000, dt=0.05e-12,
                    device=dev)
    assert llg_write.llg_write_kernel.launches == 1
    one = simulate_write(AFMTJ_PARAMS, 1.0, n_steps=3000, dt=0.05e-12,
                         device=dev)
    assert llg_write.llg_write_kernel.launches == 2
    assert torch.equal(one.energy, r.energy[1])
    assert torch.equal(one.t_switch, r.t_switch[1])


def test_write_kernel_rejects_bad_inputs(dev):
    from repro_torch.kernels.llg_write import llg_write_kernel

    v = torch.ones(2, device=dev)
    with pytest.raises(ValueError):
        llg_write_kernel(torch.zeros(2, 1, 3, device=dev), v, AFMTJ_PARAMS,
                         1e-13, 10)
    with pytest.raises(ValueError):
        llg_write_kernel(torch.zeros(2, 2, 3, device=dev), v[:1],
                         AFMTJ_PARAMS, 1e-13, 10)


# --- the process-corner paths: g_scale in the write kernel, B1's variation
# instance at a corner campaign's shape -------------------------------------
@pytest.mark.parametrize("kind,volts,n,dt", [
    ("afmtj", (0.8, 1.0, 1.2), 3000, 0.05e-12),
    ("mtj", (1.0, 2.0), 9000, 0.1e-12)])
def test_write_kernel_conductance_factor_bit_identical(dev, kind, volts, n,
                                                       dt):
    """Per-lane g_scale != 1 (an ss and an ff lane and a D2D one) on the
    card equals ref_llg_write with the same factors; all-ones factors
    equal the kernel without them."""
    from repro_torch.core import llg
    from repro_torch.kernels.llg_write import llg_write_kernel

    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    m0 = llg.initial_state(p, theta0=0.2, phi0=0.3, device=dev)
    m0 = m0.expand(len(volts), *m0.shape).contiguous()
    v = torch.tensor(volts, dtype=torch.float32, device=dev)
    gs = torch.tensor([1 / 1.15, 1 / 0.87, 0.93][:len(volts)],
                      dtype=torch.float32, device=dev)
    got = llg_write_kernel(m0, v, p, dt, n, True, gs)
    torch.cuda.synchronize()
    want = ref.ref_llg_write(m0, v, p, dt, n, True, gs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ones = llg_write_kernel(m0, v, p, dt, n, True, torch.ones_like(gs))
    none = llg_write_kernel(m0, v, p, dt, n, True)
    for a, b in zip(ones, none):
        assert torch.equal(a, b)


def test_simulate_write_corner_sample_on_the_card(dev):
    from repro_torch.core.device import simulate_write
    from repro_torch.core.params import CORNER_SS, VariationSpec
    from repro_torch.kernels import llg_write

    s = VariationSpec(corners=(CORNER_SS,)).sample_device(AFMTJ_PARAMS)
    llg_write.reset_counts()
    got = simulate_write(AFMTJ_PARAMS, 1.0, n_steps=3000, dt=0.05e-12,
                         variation=s, device=dev)
    assert llg_write.llg_write_kernel.launches == 1
    want = simulate_write(AFMTJ_PARAMS, 1.0, n_steps=3000, dt=0.05e-12,
                          variation=s, device="cpu")
    assert torch.equal(got.t_switch.cpu(), want.t_switch)
    assert torch.equal(got.energy.cpu(), want.energy)


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_variation_campaign_every_layout_equals_c1t1(dev, kind):
    """B1's variation instance at a corner campaign's shape (3 corners x 2
    temperatures x 2 voltages x 64 samples: 3,072 lanes in a 4,096-lane
    bucket), packed as run_campaign packs it: every layout of the rule's
    kind bit-identical to C1T1, and the rule's launch counted as V = 1."""
    import dataclasses

    from repro_torch.campaign import CampaignGrid, run_campaign
    from repro_torch.campaign.engine import EARLY_EXIT_CHUNK
    from repro_torch.campaign.grid import bucket_cells, pack_variation
    from repro_torch.core.params import (CORNER_FF, CORNER_SS, CORNER_TT,
                                         VariationSpec)
    from repro_torch.kernels.llg_rk4 import layout_rule, sm_count

    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    dt, pulse = (0.1e-12, 150e-12) if kind == "afmtj" else (0.2e-12, 800e-12)
    spec = VariationSpec(corners=(
        CORNER_TT, dataclasses.replace(CORNER_SS, sigma_r=0.05), CORNER_FF))
    grid = CampaignGrid(voltages=(1.0, 1.4) if kind == "afmtj" else (2.0, 3.0),
                        pulse_widths=(pulse,), temperatures=(300.0, 350.0),
                        n_samples=64, dt=dt, seed=2, variation=spec)
    state, seeds, sigma, budget, lp, _ = pack_variation(grid, p, dev)
    pad = bucket_cells(state.shape[1]) - state.shape[1]
    state = torch.nn.functional.pad(state, (0, pad))
    seeds = torch.nn.functional.pad(seeds, (0, pad))
    sigma = torch.nn.functional.pad(sigma, (0, pad))
    budget = torch.nn.functional.pad(budget, (0, pad))
    fill = torch.tensor([[p.alpha], [p.b_aniso], [1.0]], device=dev)
    lp = torch.cat([lp, fill.expand(3, pad)], dim=1)
    n = 1 << (grid.n_steps - 1).bit_length()
    kw = dict(thermal_sigma=sigma, seeds=seeds, step_budget=budget,
              chunk=EARLY_EXIT_CHUNK, lane_params=lp)
    cells = state.shape[1]
    c1t1 = llg_rk4_kernel(state, p, dt, n, **kw, layout=(1, 1, 0))
    rule = layout_rule(cells, p.n_sublattices, sm_count(dev.index or 0), True)
    for lay in {rule, (rule[0], 1, rule[2]), (8, 1, 1), (16, 1, 0)}:
        out = llg_rk4_kernel(state, p, dt, n, **kw, layout=lay)
        torch.cuda.synchronize()
        assert torch.equal(out, c1t1), lay
    llg_rk4_kernel.launch_layouts.clear()
    res = run_campaign(p, grid, use_cache=False, device=dev)
    assert res.crossing_time.shape == (3, 2, 2, 64)
    assert list(llg_rk4_kernel.launch_layouts) == [
        (cells, p.n_sublattices, *rule, 1)]
    assert (out[7, :grid.cells] < n).any()


# --- the write-path / fault-cost remainder and serving (chip_smoke phase 8) ---

@pytest.fixture
def fresh_writes(tmp_path, monkeypatch):
    """No campaign or write-characterization cache carried between tests."""
    from repro_torch.circuit import subarray
    from repro_torch.imc import write_margin, write_path

    monkeypatch.setenv("REPRO_TORCH_CAMPAIGN_CACHE", str(tmp_path))
    fns = (write_margin.wer_margined_pulse, write_path.measured_write_timings,
           write_path.nominal_pulse, subarray._characterize_write)
    for f in fns:
        f.cache_clear()
    yield
    for f in fns:
        f.cache_clear()


def test_write_error_rate_is_one_launch(dev, fresh_writes):
    """One LLG launch; the scan baseline on the card agrees within 3
    binomial standard errors of the difference at the pooled rate."""
    from repro_torch.core import montecarlo

    before = llg_rk4_kernel.launches
    w_k = montecarlo.write_error_rate(AFMTJ_PARAMS, 1.0, 200e-12,
                                      n_samples=1024, device=dev)
    assert llg_rk4_kernel.launches == before + 1
    w_s = montecarlo.write_error_rate_scan(AFMTJ_PARAMS, 1.0, 200e-12,
                                           n_samples=256, device=dev)
    assert llg_rk4_kernel.launches == before + 1
    p = (w_k * 1024 + w_s * 256) / 1280
    assert abs(w_k - w_s) <= 3 * math.sqrt(p * (1 - p) * (1 / 1024 + 1 / 256))


def test_program_bits_and_write_surface_on_card(dev, fresh_writes):
    import numpy as np

    from repro_torch.imc import write_path

    target = np.random.default_rng(8).integers(0, 2, (32, 32))
    pol = write_path.WritePolicy(pulse=120e-12, max_attempts=3,
                                 use_cache=False)
    before = llg_rk4_kernel.launches
    res, err = write_path.program_bits(target, "afmtj", pol, device=dev)
    assert llg_rk4_kernel.launches - before == res.rounds > 0
    assert res.attempts.size == target.sum()
    assert err.sum() == (~res.success).sum() and not err[target == 0].any()
    before = llg_rk4_kernel.launches
    surf = write_path.write_surface("afmtj", voltages=(0.8, 1.2),
                                    temperatures=(300.0, 375.0), n_cells=64,
                                    policy=pol, device=dev)
    assert surf.residual_ber.shape == (2, 2, 1)
    assert llg_rk4_kernel.launches - before >= 4


def test_fault_costs_on_card(dev, fresh_writes):
    from repro_torch.imc import evaluate
    from repro_torch.imc.faults import REPAIR_SPARE, FaultSpec
    from repro_torch.imc.mapping import fault_cost_factors

    spec = FaultSpec.at_rate(1e-3)
    nominal = evaluate.evaluate_system("afmtj", device=dev)
    for repair in (None, REPAIR_SPARE):
        y, ovh, stretch = fault_cost_factors(spec, repair)
        res = evaluate.evaluate_system("afmtj", faults=spec, repair=repair,
                                       device=dev)
        for name, r in res.items():
            assert r.t_imc == pytest.approx(nominal[name].t_imc * stretch,
                                            rel=1e-12)
            assert r.e_imc == pytest.approx(nominal[name].e_imc * ovh,
                                            rel=1e-12)
            assert r.array_yield == y


def test_write_energy_accuracy_surface_launches_b1_and_b3(dev, no_tf32,
                                                          fresh_writes):
    from repro_torch.configs.registry import get_arch
    from repro_torch.imc import mapping, write_path

    analog_mac.reset_counts(bitline_mac_kernel)
    before = llg_rk4_kernel.launches
    pts = mapping.write_energy_accuracy_surface(
        get_arch("qwen2-0.5b"), policy=write_path.WritePolicy(
            pulse=150e-12, use_cache=False),
        wer_targets=(3e-1, 1e-2), n_cells=128, cap_k=128, cap_n=256,
        batch=4, device=dev)
    assert bitline_mac_kernel.launches == 2
    assert llg_rk4_kernel.launches > before
    a, b = pts[3e-1], pts[1e-2]
    assert a.attempts_budget <= b.attempts_budget
    assert a.report.nmse >= b.report.nmse and b.e_write_bit >= a.e_write_bit


@pytest.mark.parametrize("arch", [
    "qwen2-0.5b", "gemma2-2b", "olmoe-1b-7b", "mamba2-780m",
    "jamba-1.5-large-398b", "llama4-maverick-400b-a17b",
    "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_serving_on_card_matches_cpu(dev, no_tf32, arch):
    """The same parameters on the card and the CPU (smoke configs, with
    frontend embeddings or encoder frames where the arch has them): prefill
    and decode logits within 1e-4 (float32, TF32 off), decode == forward at
    the reference's 2e-2."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.engine import init_serve_params
    from repro_torch.models import model as M

    cfg = smoke_config(arch)
    params = init_serve_params(cfg, 0, "cpu")
    on_card = M.params_to(params, dev)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    extra, pos0 = {}, 0
    if cfg.frontend_positions:
        key = ("encoder_frames" if cfg.n_encoder_layers
               else "frontend_embeds")
        extra[key] = torch.randn(2, cfg.frontend_positions, cfg.d_model,
                                 generator=gen)
        pos0 = 0 if cfg.n_encoder_layers else cfg.frontend_positions
    out = {}
    for d, p in (("cpu", params), (dev, on_card)):
        t = toks.to(d)
        ex = {k: v.to(d) for k, v in extra.items()}
        with torch.no_grad():
            lp, cache = M.serve_prefill(p, cfg, dict(ex, tokens=t[:, :16]),
                                        max_seq=pos0 + 20)
            ld, cache = M.serve_step(p, cfg, cache, t[:, 16:])
            lf, _ = M.serve_prefill(p, cfg, dict(ex, tokens=t),
                                    max_seq=pos0 + 20)
        out[str(d)] = (lp.cpu(), ld.cpu(), lf.cpu())
        assert cache["pos"] == pos0 + 17
        torch.testing.assert_close(ld[:, 0].cpu(), lf[:, -1].cpu(),
                                   atol=2e-2, rtol=2e-2)
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", [
    "qwen2-0.5b", "gemma2-2b", "olmoe-1b-7b", "mamba2-780m",
    "jamba-1.5-large-398b", "llama4-maverick-400b-a17b",
    "seamless-m4t-large-v2", "qwen2-vl-2b", "qwen3-8b", "internlm2-20b"])
def test_train_step_on_card_matches_cpu(dev, no_tf32, arch):
    """One train step (2 microbatches, step 100, lr 3e-3) of the same
    parameters on the card and the CPU (smoke configs, float32): loss
    within 1e-4 (jamba 1e-3, ROADMAP C14), gradient norm within 3e-3
    (seamless measured 9.2e-4 on the H100; on the CPU its float32 norm
    sits 5.7e-4 from float64, ROADMAP C16), every gradient on the card
    finite (no inf x 0 in a masked exp's backward)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = smoke_config(arch)
    shape = ShapeConfig("t", "train", 32, 4, microbatches=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_at(data_config(cfg, shape), 0)
    step = ST.make_train_step(cfg, shape, AdamWConfig(lr=3e-3))
    met = {}
    for d in ("cpu", dev):
        p = M.params_to(params, d)
        m, v = adamw_init(p)
        *_, met[str(d)] = step(p, m, v, 100, {
            k: torch.from_numpy(a).to(d) for k, a in batch.items()})
    c, g = met["cpu"], met[str(dev)]
    rtol = 1e-3 if arch.startswith("jamba") else 1e-4
    assert g["loss"].item() == pytest.approx(c["loss"].item(), rel=rtol)
    assert g["grad_norm"].item() == pytest.approx(c["grad_norm"].item(),
                                                  rel=3e-3)
    _, grads = ST.make_grad_step(cfg, shape)(M.params_to(params, dev), {
        k: torch.from_numpy(a).to(dev) for k, a in batch.items()})
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(grads))


def test_train_resume_on_card_is_bit_equal(dev, tmp_path):
    """``train`` on the card stopped at step 102 and resumed ends on the
    checkpoint of a run that was not stopped, bit for bit."""
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig

    cfg = smoke_config("qwen2-0.5b")
    shape = ShapeConfig("r", "train", 16, 4, microbatches=2)
    kw = dict(save_every=2, step0=100, total_steps=10000)
    train(cfg, shape, AdamWConfig(lr=3e-3), 104, tmp_path / "a", **kw)
    train(cfg, shape, AdamWConfig(lr=3e-3), 102, tmp_path / "b", **kw)
    train(cfg, shape, AdamWConfig(lr=3e-3), 104, tmp_path / "b", **kw)
    like = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = {"params": like, "m": like, "v": like, "step": torch.zeros(())}
    a = Checkpointer(tmp_path / "a" / cfg.name).restore(104, like)
    b = Checkpointer(tmp_path / "b" / cfg.name).restore(104, like)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
