"""The port's measured read path (DESIGN.md §10) against the JAX reference
on the CPU: sense-amp offsets, read disturb, retention, sense-margin yield,
measured read timings and the refresh policy charged into Fig. 4.

Shared inputs: the port's ``grid.tilt_draws`` is handed the reference's
``jax.random`` tilts; the reference runs its plain (``ref``) campaign
backend.  Reductions (escape-time MLE, Arrhenius fits, the disturb fit,
the refresh policy) are held on the same crossing rows: both sides'
``run_campaign`` are handed one synthetic crossing tensor.

Bounds:
* ``sa_offsets``: within 4 float32 ulp of the reference's (ROADMAP C4:
  Box-Muller normals of two libraries), exact zeros at sigma 0; the
  deterministic sense paths (``offset=None``) equal today's, bit for bit.
* Campaign crossing rows: crossed and uncrossed sets equal; at most 1% of
  lanes by at most 2 steps (C3) for the 0.6 ns / 6,001-step retention
  pair, at most 5% by at most 30 steps for the 0.6 ns disturb onset at
  400 K (marginal crossings, see its test).
* Sense-margin yield: yields within one lane (1 / n), latch times rtol 1e-6
  and margins atol 5e-7 V (the conductance factors agree to 2e-6, which
  moves a lane's 0.2 V differential through 5 kOhm by at most 4.4e-7 V;
  measured 1.9e-9 V).
* Reductions on the same rows: equal to the reference's to rtol 1e-12.
* ``evaluate_system`` with every read-path option off: today's numbers,
  bit for bit (``FIG4_TODAY``: the port's output before the read path,
  given the reference's write characterization).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.campaign.engine as jengine
import repro.campaign.grid as jgrid_mod
from repro.campaign import CampaignGrid as JGrid
from repro.circuit import senseamp as jsa
from repro.circuit import subarray as jsub
from repro.circuit.bitline import BitlineParams as JBitline
from repro.core import params as jparams
from repro.imc import evaluate as jeval
from repro.imc import read_path as jrp
import repro_torch.campaign.engine as tengine
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.circuit import senseamp as tsa
from repro_torch.circuit import subarray as tsub
from repro_torch.circuit.bitline import BitlineParams, multi_row_current
from repro_torch.core.params import (AFMTJ_PARAMS, CORNER_FF, CORNER_SS,
                                     CORNER_TT, VariationSpec)
from repro_torch.imc import evaluate as teval
from repro_torch.imc import read_path as trp
from repro_torch.imc import write_path as twp

ROW7_FRAC, ROW7_STEPS = 0.01, 2
TT_ONLY = VariationSpec(corners=(CORNER_TT,))
# the port's evaluate_system(kind) before the read path, with the
# reference's write characterization: (t_imc, e_imc) per workload
FIG4_TODAY = {
    "afmtj": {
        "bnn": ("0x1.2af66f7e21646p-22", "0x1.8b9a508037a98p-25"),
        "img-grayscale": ("0x1.d8697fecd9f30p-16", "0x1.0900c36b0c73bp-19"),
        "img-threshold": ("0x1.40bba319b655cp-17", "0x1.c2d42924cf0c9p-22"),
        "mac": ("0x1.819dd572b59fep-15", "0x1.b8304e1d28a91p-19"),
        "mat_add": ("0x1.43006a70914cbp-16", "0x1.62d1fc23fcb21p-20"),
        "rmse": ("0x1.a6f81ad1c7c97p-14", "0x1.e3fc30c9afb65p-18")},
    "mtj": {
        "bnn": ("0x1.215271d32047bp-20", "0x1.3fc1d7b896c22p-22"),
        "img-grayscale": ("0x1.47237beb0e8c0p-15", "0x1.61dcdc244a498p-17"),
        "img-threshold": ("0x1.6c22cf621cbc3p-17", "0x1.03bcd7589dcefp-19"),
        "mac": ("0x1.102e458a58ec2p-14", "0x1.26b22217ede15p-16"),
        "mat_add": ("0x1.b50de8ac79cbbp-16", "0x1.d832503d0319ep-18"),
        "rmse": ("0x1.2b55676f8d55ap-13", "0x1.44230f1960108p-15")}}


def _ref_spec(spec):
    if spec is None:
        return None
    return jparams.VariationSpec(
        corners=tuple(jparams.ProcessCorner(**dataclasses.asdict(c))
                      for c in spec.corners),
        seed=spec.seed, distribution=spec.distribution)


def _shared_tilts(grid, t_index, cells, device):
    jgrid = JGrid(voltages=grid.voltages, pulse_widths=grid.pulse_widths,
                  temperatures=grid.temperatures, n_samples=grid.n_samples,
                  dt=grid.dt, seed=grid.seed)
    zs, ph = jgrid_mod._plane_tilt_draws(jgrid, t_index, cells)
    return np.array(zs), np.array(ph)


@pytest.fixture
def shared_tilts(monkeypatch):
    monkeypatch.setattr(tgrid_mod, "tilt_draws", _shared_tilts)


def _check_crossings(got, want, dt):
    d = np.abs(got / dt - want / dt)
    assert (d > 0.5).mean() <= ROW7_FRAC
    assert d.max() <= ROW7_STEPS + 1e-6


@pytest.fixture
def shared_write_characterization(monkeypatch):
    def char(kind, v_write, device=None):
        return jsub._characterize_write(kind, float(v_write))
    monkeypatch.setattr(tsub, "_characterize_write", char)
    for f in (twp.nominal_pulse, trp.measured_read_timings,
              jrp.measured_read_timings):
        f.cache_clear()
    yield
    for f in (twp.nominal_pulse, trp.measured_read_timings,
              jrp.measured_read_timings):
        f.cache_clear()


# --- sense-amp offsets ----------------------------------------------------------
def test_sa_offsets_zero_sigma_is_exact_zero():
    assert torch.equal(tsa.sa_offsets(tsa.SenseAmpParams(), 257),
                       torch.zeros(257))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_sa_offsets_match_reference(seed):
    sa = tsa.SenseAmpParams(offset_sigma=5e-3)
    got = tsa.sa_offsets(sa, 4096, seed=seed).numpy()
    want = np.asarray(jsa.sa_offsets(jsa.SenseAmpParams(offset_sigma=5e-3),
                                     4096, seed=seed))
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all()
    np.testing.assert_array_equal(got, tsa.sa_offsets(sa, 4096,
                                                       seed=seed).numpy())
    assert abs(got.std() - 5e-3) / 5e-3 < 0.1 and abs(got.mean()) < 5e-4
    assert not np.array_equal(got, tsa.sa_offsets(sa, 4096,
                                                  seed=seed + 1).numpy())


def test_sense_delay_offset_none_is_todays_and_a_zero_offset():
    """``offset=None`` computes |di| r exactly as before; a zero offset
    gives the same bits (|di r + 0| == |di| r)."""
    sa = tsa.SenseAmpParams()
    di = torch.linspace(-2e-5, 2e-5, 101)
    today = sa.tau_latch * torch.log(
        torch.tensor(sa.v_logic) / torch.clamp(
            torch.clamp(torch.abs(di) * sa.r_trans, min=1e-6),
            max=sa.v_logic)) + sa.t_setup
    t_none = tsa.sense_delay(di, sa)
    assert torch.equal(t_none, today)
    assert torch.equal(tsa.sense_delay(di, sa, offset=torch.zeros(101)),
                       t_none)
    off = torch.full((101,), 2e-3)
    np.testing.assert_allclose(
        tsa.sense_delay(di, sa, offset=off).numpy(),
        np.asarray(jsa.sense_delay(di.numpy(), jsa.SenseAmpParams(),
                                   offset=off.numpy())), rtol=1e-6)


@pytest.mark.parametrize("op", ["and", "nand", "or", "nor", "xor", "xnor"])
def test_resolve_logic_offset_none_bit_identical(op):
    sa, bl = tsa.SenseAmpParams(), BitlineParams()
    bits = torch.tensor([[i >> 1 & 1, i & 1] for i in range(4)],
                        dtype=torch.float32)
    out0, d0 = tsa.resolve_logic(bits, op, AFMTJ_PARAMS, bl, sa)
    outz, dz = tsa.resolve_logic(bits, op, AFMTJ_PARAMS, bl, sa,
                                 offset=torch.zeros(4))
    assert torch.equal(out0, outz) and torch.equal(d0, dz)
    off = torch.tensor([3e-3, -3e-3, 1e-2, -1e-2])
    outj, dj = jsa.resolve_logic(bits.numpy(), op, jparams.AFMTJ_PARAMS,
                                 JBitline(), jsa.SenseAmpParams(),
                                 offset=off.numpy())
    outo, do = tsa.resolve_logic(bits, op, AFMTJ_PARAMS, bl, sa, offset=off)
    np.testing.assert_array_equal(outo.numpy(), np.asarray(outj))
    np.testing.assert_allclose(do.numpy(), np.asarray(dj), rtol=1e-6)


def test_resolve_logic_large_offset_flips_decision():
    sa, bl = tsa.SenseAmpParams(), BitlineParams()
    bits = torch.tensor([[1.0, 1.0]])
    out0, _ = tsa.resolve_logic(bits, "and", AFMTJ_PARAMS, bl, sa)
    gap = float(multi_row_current(bits, AFMTJ_PARAMS, bl)[0]) * sa.r_trans
    out1, _ = tsa.resolve_logic(bits, "and", AFMTJ_PARAMS, bl, sa,
                                offset=torch.tensor([-2.0 * gap]))
    assert bool(out0[0]) and not bool(out1[0])


# --- sense-margin yield ----------------------------------------------------------
def test_sense_yield_deterministic_limit_is_perfect():
    sy = trp.sense_margin_yield("afmtj", v_reads=(0.1,),
                                sa=tsa.SenseAmpParams(offset_sigma=0.0),
                                variation=TT_ONLY, n_samples=512,
                                device="cpu")
    assert (sy.yield_surface == 1.0).all() and sy.margin_min.min() > 0.0


@pytest.fixture(scope="module")
def sense_pair():
    got = trp.sense_margin_yield("afmtj", n_samples=2048, seed=0,
                                 device="cpu")
    want = jrp.sense_margin_yield("afmtj", n_samples=2048, seed=0)
    return got, want


def test_sense_yield_matches_reference(sense_pair):
    got, want = sense_pair
    assert got.corner_names == want.corner_names
    assert got.v_reads == want.v_reads
    np.testing.assert_allclose(got.yield_surface, want.yield_surface, rtol=0,
                               atol=1.0 / got.n_samples + 1e-12)
    np.testing.assert_allclose(got.t_sense, want.t_sense, rtol=1e-6)
    np.testing.assert_allclose(got.margin_min, want.margin_min, rtol=0,
                               atol=5e-7)


def test_sense_yield_ladders_with_read_voltage(sense_pair):
    sy, want = sense_pair
    y = sy.yield_surface
    assert y.shape == (3, len(sy.v_reads))
    assert (np.diff(y, axis=1) >= 0).all()
    v = sy.v_read_for_yield(0.999)
    assert v == want.v_read_for_yield(0.999)
    with pytest.raises(ValueError):
        sy.v_read_for_yield(1.0 + 1e-9)


def test_sense_yield_nominal_trim_and_time_budget(sense_pair):
    """Without corner trim the slow corner's D2D tail crosses the nominal
    reference (a ceiling no read voltage lifts); a tight latch budget costs
    yield."""
    kw = dict(v_reads=(0.1, 0.2), n_samples=2048, seed=0, device="cpu")
    trimmed = trp.sense_margin_yield("afmtj", ref_trim="corner", **kw)
    untrimmed = trp.sense_margin_yield("afmtj", ref_trim="nominal", **kw)
    si = list(trimmed.corner_names).index("ss")
    assert untrimmed.yield_surface[si].max() < 0.995
    assert trimmed.yield_surface[si].max() > 0.999
    base = sense_pair[0]
    tight = trp.sense_margin_yield("afmtj", n_samples=2048, seed=0,
                                   t_budget=float(base.t_sense.min()),
                                   device="cpu")
    assert tight.yield_surface.min() < base.yield_surface.min()


def test_size_read_drive_matches_reference():
    kw = dict(yield_target=0.999, r_trans_ladder=(2.5e3, 5e3), n_samples=1024)
    got = trp.size_read_drive("afmtj", device="cpu", **kw)
    want = jrp.size_read_drive("afmtj", **kw)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert (g.v_read, g.r_trans) == (w.v_read, w.r_trans)
        np.testing.assert_allclose(g.read_yield, w.read_yield, atol=1 / 1024)
        np.testing.assert_allclose(g.t_sense, w.t_sense, rtol=1e-6)


def test_measured_read_timings_thread_into_subarray(
        shared_write_characterization):
    sa = tsa.SenseAmpParams(offset_sigma=5e-3)
    det = tsub.make_subarray("afmtj", rows=64, cols=64, device="cpu")
    meas = tsub.make_subarray("afmtj", rows=64, cols=64, read_percentile=99.0,
                              sa=sa, device="cpu")
    want = jsub.make_subarray("afmtj", rows=64, cols=64, read_percentile=99.0,
                              sa=jsa.SenseAmpParams(offset_sigma=5e-3))
    assert det.timings.read_percentile is None
    assert det.timings.read_yield == 1.0
    assert meas.timings.read_percentile == 99.0
    assert 0.9 < meas.timings.read_yield <= 1.0
    assert meas.timings.t_read > det.timings.t_read
    np.testing.assert_allclose(meas.timings.t_read, want.timings.t_read,
                               rtol=1e-6)
    np.testing.assert_allclose(meas.timings.read_yield,
                               want.timings.read_yield, atol=1 / 4096)
    mr = trp.measured_read_timings("afmtj", v_read=0.1, percentile=99.0,
                                   device="cpu")
    assert mr is trp.measured_read_timings("afmtj", v_read=0.1,
                                           percentile=99.0, device="cpu")


# --- campaigns against the reference ----------------------------------------------
@pytest.fixture(scope="module")
def retention_pair():
    """Zero drive on the log horizon ladder at 0.6 ns (6,001 steps), the
    reference test's size, on shared tilts."""
    kw = dict(accel_factors=(0.05,), temperatures=(300.0,),
              horizons=(0.2e-9, 0.6e-9), n_samples=32, use_cache=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgrid_mod, "tilt_draws", _shared_tilts)
        got = trp.retention_campaign("afmtj", variation=TT_ONLY,
                                     device="cpu", **kw)
    want = jrp.retention_campaign("afmtj", variation=_ref_spec(TT_ONLY),
                                  backend="ref", **kw)
    return got, want


def test_retention_zero_drive_long_horizon_matches_reference(retention_pair):
    got, want = retention_pair
    ct, cw = got.result.crossing_time, want.result.crossing_time
    horizon = max(got.grid.pulse_widths)
    assert ct.shape == cw.shape == (1, 1, 1, 32)
    np.testing.assert_array_equal(ct >= horizon, cw >= horizon)
    _check_crossings(ct, cw, got.grid.dt)
    assert (ct < horizon).any() and (ct >= horizon).any()
    assert got.n_launches == 1


def test_retention_log_ladder_changes_no_crossing(retention_pair, monkeypatch):
    """The log rung (10,000 steps here) only changes the launch horizon:
    the budget row stops real lanes at 6,001 steps, so the crossing rows
    equal the fixed-horizon launch's (checked on the launches' inputs, at
    the first 1,200 steps, where both runs are cheap)."""
    got, _ = retention_pair
    assert tengine._quantize_steps(got.grid.n_steps, "log") == 10000
    grid = dataclasses.replace(got.grid, pulse_widths=(0.12e-9,))
    exact = tengine.run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                                 chunk=0, device="cpu")
    logged = tengine.run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                                  horizon="log", device="cpu")
    np.testing.assert_array_equal(logged.crossing_time, exact.crossing_time)
    with pytest.raises(ValueError):
        tengine._quantize_steps(100, "linear")


def test_disturb_sub_threshold_crossings_match_reference(shared_tilts):
    """Drive across the onset at 400 K (0.1 V holds; 0.28 / 0.32 V flip
    4 / 9 of 48 lanes some 4,100-4,600 steps in): crossed and uncrossed
    sets equal the reference's.  These marginal, thermally assisted
    crossings sit thousands of steps on a slow saddle, where the
    reference's fused multiply-adds and the port's separate roundings
    (C3) part by more than in the write regime: crossing steps within 30
    (0.5% of the horizon) on at most 5% of lanes (measured: 5 of 144
    lanes, up to 22 steps; ROADMAP C9)."""
    kw = dict(voltages=(0.10, 0.28, 0.32), pulses=(0.6e-9,),
              temperatures=(400.0,), n_samples=48, use_cache=False)
    got = trp.read_disturb_campaign("afmtj", device="cpu", **kw)
    want = jrp.read_disturb_campaign("afmtj", backend="ref", **kw)
    dt = got.grid.dt
    ct, cw = got.result.crossing_time, want.result.crossing_time
    horizon = got.grid.n_steps * dt
    np.testing.assert_array_equal(ct >= horizon, cw >= horizon)
    d = np.abs(ct - cw) / dt
    assert (d > 0.5).mean() <= 0.05 and d.max() <= 30 + 1e-6
    assert (ct < horizon).any() and (ct[0, 0] >= horizon).all()
    np.testing.assert_allclose(got.disturb_surface(), want.disturb_surface(),
                               atol=1.0 / 48 + 1e-12)
    assert got.p1(v_index=2) == float(got.disturb_surface()[0, 2, -1]) > 0
    assert got.p1_upper() == got.p1() + 3.0 / 48


def test_disturb_campaign_is_one_launch(monkeypatch):
    calls = []

    def fake_kernel(state, p, dt, n, thr, **kw):
        calls.append((state.shape[1], kw["lane_params"] is not None))
        out = state.clone()
        out[7] = float(n)
        return out

    monkeypatch.setattr(tengine, "llg_rk4_kernel", fake_kernel)
    res = trp.read_disturb_campaign("afmtj", voltages=(0.10, 0.24),
                                    pulses=(0.2e-9,),
                                    temperatures=(300.0, 400.0),
                                    n_samples=32, use_cache=False,
                                    device="cpu")
    assert res.n_launches == 1 and calls == [(1024, False)]
    spec = VariationSpec(corners=(CORNER_TT, CORNER_SS, CORNER_FF))
    res = trp.read_disturb_campaign("afmtj", voltages=(0.10, 0.24),
                                    pulses=(0.2e-9,), temperatures=(300.0,),
                                    n_samples=32, variation=spec,
                                    use_cache=False, device="cpu")
    assert res.disturb_surface().shape == (3, 1, 2, 1)
    assert calls[-1] == (2048, True)


# --- reductions on the same rows ----------------------------------------------------
def _synthetic_rows(grid, horizon_scale=1.0):
    """Deterministic escape times of every (corner, T, V, S) lane: an
    exponential whose mean falls with the drive voltage and the corner's
    barrier; lanes past the grid's horizon never crossed."""
    n_c = grid.n_corners
    n_t, n_v, _, n_s = grid.shape
    rng = np.random.default_rng(grid.seed + 17)
    horizon = grid.n_steps * grid.dt
    ct = np.empty((n_c, n_t, n_v, n_s))
    for ci in range(n_c):
        b = (1.0 if grid.variation is None
             else grid.variation.corners[ci].b_aniso_factor)
        for vi, v in enumerate(grid.voltages):
            tau = horizon_scale * 2e-10 * math.exp(40.0 * b * (1 - v / 0.3))
            ct[ci, :, vi] = np.minimum(rng.exponential(tau, (n_t, n_s)),
                                       horizon)
    return ct if grid.variation is not None else ct[0]


def _fake_run_campaign(result_cls):
    def run(p, grid, **kw):
        return result_cls(grid=grid, backend="synthetic",
                          crossing_time=_synthetic_rows(grid), elapsed_s=0.0)
    return run


@pytest.fixture
def same_rows(monkeypatch):
    monkeypatch.setattr(tengine, "run_campaign",
                        _fake_run_campaign(tengine.CampaignResult))
    monkeypatch.setattr(jengine, "run_campaign",
                        _fake_run_campaign(jengine.CampaignResult))
    for f in (trp.derive_refresh_policy, jrp.derive_refresh_policy):
        f.cache_clear()
    yield
    for f in (trp.derive_refresh_policy, jrp.derive_refresh_policy):
        f.cache_clear()


def _same(got, want, rtol=1e-12):
    if isinstance(want, str) or (isinstance(want, float)
                                 and math.isinf(want)):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_retention_reductions_match_reference(same_rows):
    got = trp.retention_campaign("afmtj", device="cpu")
    want = jrp.retention_campaign("afmtj")
    np.testing.assert_array_equal(got.result.crossing_time,
                                  want.result.crossing_time)
    assert got.grid.n_steps == want.grid.n_steps == 40001
    assert got.grid.pulse_widths == want.grid.pulse_widths
    np.testing.assert_array_equal(got.n_flips, want.n_flips)
    np.testing.assert_array_equal(got.tau_acc, want.tau_acc)
    _same(got.delta_eff(), want.delta_eff())
    _same(got.delta_op(), want.delta_op())
    for ci in range(3):
        _same(got.arrhenius_fit(ci, 0), want.arrhenius_fit(ci, 0))
        _same(got.tau0(ci, 0), want.tau0(ci, 0))
    _same(got.tau_op(), want.tau_op())
    _same(got.retention_percentiles(), want.retention_percentiles())
    _same(got.worst_tau_op(), want.worst_tau_op())
    assert trp.retention_horizons("mtj") == jrp.retention_horizons("mtj")


def test_disturb_fit_matches_reference(same_rows):
    got = trp.fit_disturb_model("afmtj", device="cpu")
    want = jrp.fit_disturb_model("afmtj")
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))
    for v in (0.0, 0.05, 0.1, 0.2, 0.4):
        _same(got.suppression(v), want.suppression(v))
        _same(got.p1(v, 0.5e-9, 40.0, 1e-9), want.p1(v, 0.5e-9, 40.0, 1e-9))
    with pytest.raises(ValueError):
        trp.fit_disturb_model("afmtj", voltages=(0.05, 0.1), device="cpu")


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_refresh_policy_matches_reference(same_rows, kind):
    got = trp.derive_refresh_policy(kind, device="cpu")
    want = jrp.derive_refresh_policy(kind)
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.parametrize("p1,n", [(0.0, 1e9), (3e-7, 1000.0), (0.25, 7.0),
                                  (1.0, 2.0)])
def test_disturb_algebra_matches_reference(p1, n):
    assert trp.accumulated_disturb(p1, n) == jrp.accumulated_disturb(p1, n)
    for budget in (1e-9, 1e-4):
        assert (trp.reads_between_refresh(p1, budget)
                == jrp.reads_between_refresh(p1, budget))
    if 0.0 < p1 < 1.0:
        nb = trp.reads_between_refresh(p1, 1e-4)
        assert abs(trp.accumulated_disturb(p1, nb) - 1e-4) / 1e-4 < 1e-9


@pytest.mark.parametrize("ct,horizon", [([1.0, 3.0], 10.0),
                                        ([2.0, 20.0], 10.0),
                                        ([20.0, 20.0], 10.0)])
def test_censored_tau_matches_reference(ct, horizon):
    ct = np.array(ct)
    assert trp._censored_tau(ct, horizon) == jrp._censored_tau(ct, horizon)


def test_disturb_model_suppression_shape():
    m = trp.DisturbModel(kind="afmtj", v_c=0.2, beta=1.5, accel_factor=0.1,
                         delta_acc=4.0, tau0_acc=1e-9, voltages=(0.0,),
                         tau_meas=(1e-9,), sse=0.0)
    assert m.suppression(0.0) == 1.0 and m.suppression(0.25) == 0.0
    vs = np.linspace(0.0, 0.19, 20)
    assert (np.diff([m.suppression(v) for v in vs]) < 0).all()
    assert (np.diff([m.p1(v, 1e-9, 40.0, 0.25e-9) for v in vs]) > 0).all()


# --- Fig. 4 with the read path ----------------------------------------------------
@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_evaluate_system_read_options_off_is_todays(
        kind, shared_write_characterization):
    inert = trp.RefreshPolicy(interval=math.inf, limited_by="none",
                              tau_retention=math.inf, p1_read=0.0,
                              reads_max=math.inf, ber_budget=1e-9,
                              reads_per_cell_s=1e6)
    for res in (teval.evaluate_system(kind, device="cpu"),
                teval.evaluate_system(kind, read_percentile=None,
                                      offset_sigma=0.0, refresh=inert,
                                      device="cpu")):
        assert set(res) == set(FIG4_TODAY[kind])
        for name, (t_imc, e_imc) in FIG4_TODAY[kind].items():
            r = res[name]
            assert (r.t_imc, r.e_imc) == (float.fromhex(t_imc),
                                          float.fromhex(e_imc)), name
            assert r.t_refresh == 0.0 and r.e_refresh == 0.0
            assert math.isinf(r.refresh_interval)


def test_refresh_charging_matches_reference(shared_write_characterization):
    def pol(mod, interval):
        return mod.RefreshPolicy(interval=interval, limited_by="disturb",
                                 tau_retention=1e7, p1_read=1e-10,
                                 reads_max=10.0, ber_budget=1e-9,
                                 reads_per_cell_s=1e6)

    base = teval.evaluate_system("afmtj", device="cpu")
    slow = teval.evaluate_system("afmtj", refresh=pol(trp, 1e-4),
                                 device="cpu")
    fast = teval.evaluate_system("afmtj", refresh=pol(trp, 1e-5),
                                 device="cpu")
    want = jeval.evaluate_system("afmtj", refresh=pol(jrp, 1e-5))
    for name, r in base.items():
        assert 0.0 < slow[name].t_refresh < fast[name].t_refresh
        assert fast[name].e_imc > slow[name].e_imc > r.e_imc
        assert slow[name].t_imc == pytest.approx(r.t_imc
                                                 + slow[name].t_refresh)
        assert slow[name].speedup < r.speedup
        for f in ("t_imc", "e_imc", "t_refresh", "e_refresh"):
            np.testing.assert_allclose(getattr(fast[name], f),
                                       getattr(want[name], f), rtol=1e-6)
        assert fast[name].refresh_interval == 1e-5


def test_evaluate_system_measured_read_matches_reference(
        shared_write_characterization):
    kw = dict(read_percentile=99.0, offset_sigma=5e-3)
    got = teval.evaluate_system("afmtj", device="cpu", **kw)
    want = jeval.evaluate_system("afmtj", **kw)
    for name in want:
        for f in ("t_imc", "e_imc", "speedup", "energy_saving"):
            np.testing.assert_allclose(getattr(got[name], f),
                                       getattr(want[name], f), rtol=1e-6)
    base = teval.evaluate_system("afmtj", device="cpu")
    assert all(got[n].t_imc >= base[n].t_imc for n in base)


def test_refresh_policy_is_hashable_pure_data():
    p = trp.RefreshPolicy(interval=1e-4, limited_by="retention",
                          tau_retention=1e7, p1_read=0.0, reads_max=math.inf,
                          ber_budget=1e-9, reads_per_cell_s=1e6)
    assert hash(p) == hash(dataclasses.replace(p))
    assert trp.default_retention_spec().corner_names == ("tt", "ss", "ff")
    assert trp.default_read_spec().corners[1].sigma_r == trp.READ_D2D_SIGMA_R
    assert {CORNER_SS.name, CORNER_FF.name} < set(
        trp.default_read_spec().corner_names)
