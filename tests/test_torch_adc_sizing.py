"""The fake-analog operand sizing on the CPU (``kernels.adc_sizing``, its
plain version ``ref.ref_adc_aux``, and ``imc.model_analog.fake_operands``
around them).

* The kernel's two-significant-digit rounding, a search in
  ``adc_sizing.rounding_table()`` (mirrored with ``bisect`` in
  ``tests/_rounding_cases.py``), equals Python's ``float(f"{y:.2g}")`` on
  1e5 log-uniform draws over [1e-30, 1e3], the doubles at and next to every
  decimal midpoint and power of ten of the table's range, and the 1e-30
  floor; each bound of the table is the least double of its value.
* The plain version sizes as the device path does: the float64 operations
  written out here in the host's order, float32 stores; the device path
  sizes with the same two functions.
* ``fake_operands`` with its scalars kept as tensors gives the operands of
  the host-float preamble it replaced (``tests/_host_preamble_oracle.py``)
  bit for bit, in every mode of the fake path.

The card's side is ``tests/test_torch_adc_sizing_cuda.py``.
"""
import math

import pytest
import torch

from _host_preamble_oracle import host_fake_operands
from _rounding_cases import (python_round_2sig, rounding_cases,
                             table_round_2sig)
from repro_torch.circuit.bitline import BitlineParams
from repro_torch.core.params import PROCESS_CORNERS, VariationSpec
from repro_torch.imc import analog_pipeline as ap
from repro_torch.imc import model_analog as ma
from repro_torch.imc.faults import REPAIR_SPARE, FaultSpec
from repro_torch.kernels import adc_sizing
from repro_torch.kernels.fake_analog import (ROW_ATT_NEG, ROW_ATT_POS,
                                             ROW_DECODE, ROW_G_AP, ROW_G_FS,
                                             ROW_G_SCALE, ROW_I_MAX,
                                             ROW_R_ACCESS)

F32 = torch.float32


def test_mirror_rounds_as_python_formats():
    cases = rounding_cases()
    assert len(cases) >= 100_000
    bad = [y for y in cases if table_round_2sig(y) != python_round_2sig(y)]
    assert not bad, bad[:10]


@pytest.mark.parametrize("y", [1e-30, 0.0, -3.0, 1e-31, 1.05e-30, 9.95e-30,
                               0.125, 0.135, 12.5, 99.5, 999.0])
def test_mirror_floor_and_ties(y):
    assert table_round_2sig(y) == python_round_2sig(y)


@pytest.mark.parametrize("y", [1e39, 3.4e39, 1e300, math.inf])
def test_mirror_beyond_its_exact_range_stores_the_same_float32(y):
    """Above 1e39 both round to a float32 infinity."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float64).to(F32)

    assert torch.equal(f32(table_round_2sig(y)), f32(python_round_2sig(y)))


def test_each_table_bound_is_the_least_double_of_its_value():
    bounds, values = adc_sizing.rounding_table()
    assert bounds[0] == values[0] == adc_sizing.FLOOR
    assert list(bounds) == sorted(set(bounds))
    assert list(values) == sorted(set(values))
    assert (bounds[-1], values[-1]) == (adc_sizing.TOP, math.inf)
    for b, v in zip(bounds[1:-1], values[1:-1]):
        assert adc_sizing.round_2sig(b) == v
        assert adc_sizing.round_2sig(math.nextafter(b, 0.0)) < v


def test_mirror_keeps_nan():
    assert math.isnan(table_round_2sig(math.nan))
    assert math.isnan(python_round_2sig(math.nan))


def _stats(seed, w_zero=False, x_zero=False):
    gen = torch.Generator().manual_seed(seed)

    def pos(scale):
        return (torch.rand((), generator=gen) * scale).to(F32)

    return dict(w_max=torch.zeros((), dtype=F32) if w_zero else pos(2.0),
                x_max=torch.zeros((), dtype=F32) if x_zero else pos(9.0),
                att_mean=1.0 - pos(0.05), g_rms=pos(3e-5), v_rms=pos(0.1))


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("given_imax", [None, 3.35e-5])
@pytest.mark.parametrize("ir_drop", [True, False])
@pytest.mark.parametrize("zeros", [(False, False), (True, False),
                                   (False, True)])
def test_plain_sizing_is_the_device_paths(decode, given_imax, ir_drop, zeros):
    st = _stats(7, *zeros)
    if not ir_drop:
        st["att_mean"] = None
    n, k_rows, fs_sigmas, v_read, g_fs = 37, 896, 4.0, 0.2, 4.4e-4
    gen = torch.Generator().manual_seed(3)
    att_p, att_n = torch.rand(2, n, generator=gen)
    cell = [torch.tensor(v, dtype=F32) for v in (1e-4, 4.4e-4, 0.9, 2e3)]
    aux = adc_sizing.adc_aux_kernel(
        att_p, att_n, cell, **st, k_rows=k_rows,
        fs_sigmas=fs_sigmas, v_read=v_read, g_fs=g_fs, decode=decode,
        i_max=given_imax)
    # the host's float64 operations in the host's order
    i_max = given_imax
    if i_max is None:
        i_sigma = float(st["v_rms"]) * float(st["g_rms"]) * math.sqrt(k_rows)
        i_max = float(f"{max(fs_sigmas * i_sigma, 1e-30):.2g}")

    def scale(t):
        return float(t) if float(t) != 0.0 else 1.0

    att = 1.0 if st["att_mean"] is None else float(st["att_mean"])
    dec = ((scale(st["x_max"]) * scale(st["w_max"])) / (v_read * g_fs * att)
           if decode else 1.0)
    want = {ROW_I_MAX: i_max, ROW_DECODE: dec, ROW_G_AP: cell[0],
            ROW_G_FS: cell[1], ROW_G_SCALE: cell[2], ROW_R_ACCESS: cell[3]}
    for row, val in want.items():
        assert torch.equal(aux[row], torch.full((n,), float(val), dtype=F32))
    assert torch.equal(aux[ROW_ATT_POS], att_p)
    assert torch.equal(aux[ROW_ATT_NEG], att_n)
    assert ap.adc_full_scale is adc_sizing.adc_full_scale
    assert ap.decode_gain is adc_sizing.decode_gain


def test_sizing_needs_the_statistics():
    with pytest.raises(ValueError, match="g_rms"):
        adc_sizing.adc_aux_kernel(
            torch.ones(3), torch.ones(3), [torch.ones(())] * 4,
            w_max=torch.ones(()), x_max=torch.ones(()), att_mean=None,
            g_rms=None, v_rms=None, k_rows=1, fs_sigmas=4.0, v_read=0.2,
            g_fs=1.0, decode=True, i_max=None)


MODES = {
    "path": ap.AnalogConfig(adc_bits=8, tmr=5.0),
    "no_ir_drop": ap.AnalogConfig(adc_bits=6, ir_drop=False),
    "ss_write_ber": ap.AnalogConfig(
        adc_bits=8, write_ber=1e-2,
        variation=VariationSpec(corners=(PROCESS_CORNERS["ss"],))),
    "faults_repair": ap.AnalogConfig(
        adc_bits=6, faults=FaultSpec.at_rate(3e-2, seed=1),
        repair=REPAIR_SPARE),
    "faults_no_ir_drop": ap.AnalogConfig(
        adc_bits=4, ir_drop=False, faults=FaultSpec.at_rate(1e-2, seed=2)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("operands", ["drawn", "zero_x", "zero_w"])
@pytest.mark.parametrize("given", [(False, True), (True, False)])
def test_fake_operands_equal_the_host_preamble(mode, operands, given):
    """(v, wn, fail, aux) bit for bit, with the full scale sized or given
    and the decode gain on or off; all-zero operands take the 0 -> 1
    scale."""
    given_imax, decode = given
    acfg = MODES[mode]
    gen = torch.Generator().manual_seed(11)
    m, k, n = 5, 48, 40
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(k, n, generator=gen) / math.sqrt(k)
    if operands == "zero_x":
        x = torch.zeros_like(x)
    if operands == "zero_w":
        w = torch.zeros_like(w)
    bl = BitlineParams(rows=k)
    setup = ma.fake_setup("afmtj", acfg, "cpu", bl=bl,
                          i_max=2.5e-5 if given_imax else None, decode=decode)
    got = ma.fake_operands(x, w, setup, bl)
    want = host_fake_operands(x, w, setup, bl)
    for name, a, b in zip(("v", "wn", "fail", "aux"), got, want):
        assert torch.equal(a, b), name


# (B5 reads a fail plane, the FET round trip) per mode
SETUP_SWITCHES = {"path": (False, False), "no_ir_drop": (False, False),
                  "ss_write_ber": (True, True), "faults_repair": (True, False),
                  "faults_no_ir_drop": (True, False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fake_setup_derives_the_switches(mode):
    """A fail plane iff write errors or hard faults, the FET round trip iff
    a corner, the read-out knobs carried over, the ADC's full scale and
    decode passed through."""
    acfg = MODES[mode]
    for i_max, decode in ((None, True), (2.5e-5, False)):
        s = ma.fake_setup("afmtj", acfg, "cpu", i_max=i_max, decode=decode)
        assert (s.fail_plane, s.apply_fet) == SETUP_SWITCHES[mode]
        assert s.fail_plane == (acfg.write_ber > 0.0
                                or acfg.faults is not None)
        assert s.apply_fet == (acfg.variation is not None)
        assert (s.adc_bits, s.ir_drop, s.repair, s.faults) == (
            acfg.adc_bits, acfg.ir_drop, acfg.repair, acfg.faults)
        assert (s.ber, s.seed) == (acfg.write_ber, acfg.seed)
        assert (s.i_max, s.decode) == (i_max, decode)
        r_factor = (acfg.variation.corners[0].r_factor if s.apply_fet
                    else 1.0)
        assert torch.equal(s.g_scale, torch.tensor(1.0 / r_factor, dtype=F32))
        for t in (s.one, s.g_ap, s.g_fs, s.g_scale, s.r_access, s.v_read):
            assert t.dtype == F32 and t.dim() == 0


def test_plain_sizing_launches_nothing():
    adc_sizing.reset_counts()
    ma.fake_analog_matmul(torch.randn(16, 8) / 4.0, torch.randn(3, 16),
                          device="cpu")
    assert adc_sizing.adc_aux_kernel.launches == 0
