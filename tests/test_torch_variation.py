"""The port's process-corner variation (DESIGN.md §9) against the JAX
reference on the CPU: ``lane_rows`` / ``sample_device``, the write
kernel's conductance factor and the corner axis of the campaign engine
(its write-path clients are in ``test_torch_corner_write.py``).

Shared inputs: the reference draws its Boltzmann tilts with
``jax.random``; the port's ``grid.tilt_draws`` is handed those draws as
numpy (also for each write-verify round, which draws through it).  The
reference runs its plain (``ref``) campaign backend.

Bounds:
* ``lane_rows`` / ``sample_device``: within 2e-6 relative (the Box-Muller
  normals differ by up to 4 float32 ulp, ROADMAP C4; measured 7e-7); at
  the nominal corner every factor is 1.0 exactly.
* Packed variation planes: initial states within 1.2e-7 (sin/cos of two
  libraries), seeds, budgets and spans equal, sigma and variation rows
  within 2e-6 relative.
* Crossing rows of campaigns and ensembles: at most 1% of lanes by at most
  2 steps (C3, as ``test_torch_campaign.py``); WER may move only by the
  lanes that moved.
* Port-only properties (fused corners vs one-corner launches, the nominal
  sample, the conductance factor of the plain write) are bit for bit.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.campaign.grid as jgrid_mod
from repro.campaign import CampaignGrid as JGrid
from repro.campaign import run_campaign as jrun_campaign
from repro.campaign import run_ensemble as jrun_ensemble
from repro.core import device as jdevice, llg as jllg
from repro.core import params as jparams
import repro_torch.campaign.engine as tengine
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.campaign import CampaignGrid as TGrid
from repro_torch.campaign import cache as tcache
from repro_torch.campaign import pack_variation, run_campaign, run_ensemble
from repro_torch.core import device as tdevice
from repro_torch.core.params import (AFMTJ_PARAMS, CORNER_FF, CORNER_SS,
                                     CORNER_TT, MTJ_PARAMS, PROCESS_CORNERS,
                                     VariationSpec)
from repro_torch.kernels import ref as tref

KINDS = {"afmtj": (jparams.AFMTJ_PARAMS, AFMTJ_PARAMS),
         "mtj": (jparams.MTJ_PARAMS, MTJ_PARAMS)}
REL = 2e-6
ROW7_FRAC, ROW7_STEPS = 0.01, 2
SPEC3 = VariationSpec(corners=(
    CORNER_FF, CORNER_TT,
    dataclasses.replace(CORNER_SS, sigma_alpha=0.05, sigma_r=0.08)))
# the reference test's variation grid at a 120 ps horizon (1,201 steps;
# the reference's 250 ps rung doubles the plain version's CPU time)
VAR_GRID = dict(voltages=(0.8, 1.2), pulse_widths=(60e-12, 120e-12),
                temperatures=(280.0, 320.0), n_samples=16, seed=0)


def _ref_spec(spec):
    if spec is None:
        return None
    return jparams.VariationSpec(
        corners=tuple(jparams.ProcessCorner(**dataclasses.asdict(c))
                      for c in spec.corners),
        seed=spec.seed, distribution=spec.distribution)


def _ref_grid(grid) -> JGrid:
    return JGrid(voltages=grid.voltages, pulse_widths=grid.pulse_widths,
                 temperatures=grid.temperatures, n_samples=grid.n_samples,
                 dt=grid.dt, seed=grid.seed,
                 switch_threshold=grid.switch_threshold,
                 variation=_ref_spec(grid.variation))


def _shared_tilts(grid, t_index, cells, device):
    zs, ph = jgrid_mod._plane_tilt_draws(_ref_grid(grid), t_index, cells)
    return np.array(zs), np.array(ph)


@pytest.fixture
def shared_tilts(monkeypatch):
    monkeypatch.setattr(tgrid_mod, "tilt_draws", _shared_tilts)


def _check_crossings(got_steps, ref_steps):
    d = np.abs(got_steps - ref_steps)
    assert (d > 0.5).mean() <= ROW7_FRAC
    assert d.max() <= ROW7_STEPS + 1e-6


def _rel(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel, atol=0)


@pytest.fixture(scope="module")
def var_result():
    """The fused three-corner campaign on the reference's tilt draws."""
    grid = TGrid(**VAR_GRID, variation=SPEC3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgrid_mod, "tilt_draws", _shared_tilts)
        return grid, run_campaign(AFMTJ_PARAMS, grid, use_cache=False,
                                  device="cpu")


# --- spec semantics ------------------------------------------------------------
def test_spec_names_hash_and_cache_payload():
    assert SPEC3.corner_names == ("ff", "tt", "ss")
    assert hash(SPEC3) != hash(VariationSpec())
    json.dumps(dataclasses.asdict(SPEC3))
    assert VariationSpec().is_nominal and not SPEC3.is_nominal
    assert set(PROCESS_CORNERS) == {"tt", "ss", "ff"}
    assert _ref_spec(SPEC3).corner_names == SPEC3.corner_names


CORNER_CASES = {"tt": CORNER_TT,
                "ss_d2d": dataclasses.replace(CORNER_SS, sigma_alpha=0.1,
                                              sigma_b_aniso=0.05,
                                              sigma_volume=0.08,
                                              sigma_r=0.1),
                "ff": CORNER_FF}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("corner", sorted(CORNER_CASES))
@pytest.mark.parametrize("distribution", ["lognormal", "normal"])
def test_lane_rows_match_reference(kind, corner, distribution):
    jp, tp = KINDS[kind]
    c = CORNER_CASES[corner]
    spec = VariationSpec(corners=(c,), seed=7, distribution=distribution)
    got = spec.lane_rows(tp, c, 300, 0.1e-12, temperature=340.0, stream=1)
    want = _ref_spec(spec).lane_rows(jp, _ref_spec(spec).corners[0], 300,
                                     0.1e-12, temperature=340.0, stream=1)
    for f in ("alpha", "b_aniso", "g_scale", "volume", "sigma", "theta0"):
        _rel(getattr(got, f), getattr(want, f))
    assert got.kernel_rows.dtype == np.float32
    _rel(got.kernel_rows, want.kernel_rows)
    if c.is_nominal:
        np.testing.assert_array_equal(got.kernel_rows, want.kernel_rows)


def test_lane_rows_physics():
    rows = SPEC3.lane_rows(AFMTJ_PARAMS, CORNER_SS, 32, dt=0.1e-12)
    nom = SPEC3.lane_rows(AFMTJ_PARAMS, CORNER_TT, 32, dt=0.1e-12)
    assert (rows.alpha > nom.alpha).all()       # more damping
    assert (rows.g_scale < nom.g_scale).all()   # higher RA, less drive
    assert (rows.sigma > nom.sigma).all()       # alpha up, volume down
    assert (rows.theta0 < nom.theta0).all()     # taller barrier
    np.testing.assert_array_equal(nom.g_scale, 1.0)
    assert rows.kernel_rows.shape == (3, 32)


@pytest.mark.parametrize("corner", sorted(CORNER_CASES))
def test_sample_device_matches_reference(corner):
    c = CORNER_CASES[corner]
    spec = VariationSpec(corners=(CORNER_TT, c), seed=3)
    got = spec.sample_device(AFMTJ_PARAMS, corner_index=1, lane=5, stream=2)
    want = _ref_spec(spec).sample_device(jparams.AFMTJ_PARAMS,
                                         corner_index=1, lane=5, stream=2)
    for f in dataclasses.fields(got.params):
        _rel(getattr(got.params, f.name), getattr(want.params, f.name))
    _rel(got.g_scale, want.g_scale)
    _rel(got.volume_factor, want.volume_factor)
    _rel(got.thermal_stability, want.thermal_stability)
    if c.is_nominal:
        assert got.params == AFMTJ_PARAMS
        assert got.g_scale == 1.0 and got.volume_factor == 1.0


# --- the single-junction write with a sampled device ---------------------------
def test_simulate_write_nominal_sample_is_the_baseline():
    """The nominal corner's sample: every factor 1.0, so the write equals
    ``variation=None`` bit for bit; the slow corner is slower."""
    s = VariationSpec().sample_device(AFMTJ_PARAMS)
    kw = dict(n_steps=1600, dt=0.1e-12, device="cpu")
    r0 = tdevice.simulate_write(AFMTJ_PARAMS, 1.0, **kw)
    r1 = tdevice.simulate_write(AFMTJ_PARAMS, 1.0, variation=s, **kw)
    for f in dataclasses.fields(r0):
        assert torch.equal(getattr(r0, f.name), getattr(r1, f.name)), f.name
    ss = VariationSpec(corners=(CORNER_SS,)).sample_device(AFMTJ_PARAMS)
    r2 = tdevice.simulate_write(AFMTJ_PARAMS, 1.0, variation=ss, **kw)
    assert bool(r0.switched) and bool(r2.switched)
    assert float(r2.t_switch) > float(r0.t_switch)


@pytest.mark.parametrize("kind,v,n,dt", [("afmtj", 1.0, 1600, 0.1e-12),
                                         ("mtj", 2.5, 4000, 0.2e-12)])
def test_simulate_write_corner_matches_reference(kind, v, n, dt):
    """The ss sample (g_scale 0.87, alpha x 1.15, B_k x 1.1, volume x 0.95)
    on both sides: t_switch within one step, energy rtol 1e-5 and the
    final state within 1e-4, the bounds of ``test_torch_system.py``."""
    jp, tp = KINDS[kind]
    spec = VariationSpec(corners=(CORNER_SS,))
    got = tdevice.simulate_write(tp, v, n_steps=n, dt=dt,
                                 variation=spec.sample_device(tp),
                                 device="cpu")
    want = jdevice.simulate_write(
        jp, v, n_steps=n, dt=dt,
        variation=_ref_spec(spec).sample_device(jp))
    assert bool(got.switched) and bool(want.switched)
    assert abs(float(got.t_switch) - float(want.t_switch)) <= dt * 1.0001
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(got.final_state.numpy(),
                               np.asarray(want.final_state), atol=1e-4)


def test_plain_write_conductance_factor():
    """``ref_llg_write`` with ``g_scale`` all 1.0 equals the write without
    it, bit for bit; a factor below 1 slows the switch and lowers the
    energy per step."""
    p = AFMTJ_PARAMS
    m0 = tdevice.llg.initial_state(p, 0.1, 0.3, device="cpu")
    m0 = m0.expand(3, *m0.shape).contiguous()
    v = torch.tensor([1.5, 2.0, 2.5])
    base = tref.ref_llg_write(m0, v, p, 0.1e-12, 700)
    ones = tref.ref_llg_write(m0, v, p, 0.1e-12, 700, True, torch.ones(3))
    for a, b in zip(base, ones):
        assert torch.equal(a, b)
    low = tref.ref_llg_write(m0, v, p, 0.1e-12, 700, True,
                             torch.full((3,), 0.8))
    fin = torch.isfinite(base[1]) & torch.isfinite(low[1])
    assert fin.any() and (low[1][fin] > base[1][fin]).all()


# --- the corner axis of the campaign engine ------------------------------------
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pack_variation_matches_reference(kind, shared_tilts):
    jp, tp = KINDS[kind]
    grid = TGrid(**VAR_GRID, variation=SPEC3)
    got = pack_variation(grid, tp, "cpu")
    want = jgrid_mod.pack_variation(_ref_grid(grid), jp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1.2e-7)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).view(np.int32))
    _rel(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _rel(got[4].numpy(), np.asarray(want[4]))
    assert got[5] == want[5]


def test_pack_variation_layout():
    grid = TGrid(**VAR_GRID, variation=SPEC3)
    state, seeds, sigma, budget, lane_params, spans = pack_variation(
        grid, AFMTJ_PARAMS, "cpu")
    n_c, n_t = grid.n_corners, len(grid.temperatures)
    per = state.shape[1] // (n_c * n_t)
    assert per == tgrid_mod.bucket_cells(grid.cells)
    assert lane_params.shape == (3, state.shape[1])
    assert spans == [(si * per, si * per + grid.cells)
                     for si in range(n_c * n_t)]
    for ci in range(n_c):
        for ti in range(n_t):
            lo = (ci * n_t + ti) * per
            # thermal streams shared across corners, distinct across T
            assert torch.equal(seeds[lo:lo + per],
                               seeds[ti * per:(ti + 1) * per])
    assert (budget[:grid.cells] == grid.n_steps).all()
    assert (budget[grid.cells:per] == 0.0).all()
    # padding: nominal rows (never 0 / 0), sigma 0
    pad = lane_params[:, grid.cells:per]
    assert (pad[0] == np.float32(AFMTJ_PARAMS.alpha)).all()
    assert (pad[2] == 1.0).all() and (sigma[grid.cells:per] == 0).all()
    # the slow corner's lanes carry a hotter Brown sigma than nominal
    assert sigma[2 * n_t * per] > sigma[1 * n_t * per]


def test_fused_corners_bit_identical_to_single_corner_launches(
        var_result, shared_tilts):
    """The acceptance pin: each corner's crossing rows of the fused
    (corner x T x V x S) launch equal a one-corner campaign's, bit for bit
    (shared tilts and thermal streams)."""
    grid, res = var_result
    assert res.crossing_time.shape == (3, 2, 2, 16)
    assert res.n_launches == 1 and res.corners == ("ff", "tt", "ss")
    for ci in range(grid.n_corners):
        single = run_campaign(
            AFMTJ_PARAMS,
            dataclasses.replace(grid, variation=grid.variation.at_corner(ci)),
            use_cache=False, device="cpu")
        np.testing.assert_array_equal(res.crossing_time[ci],
                                      single.crossing_time[0])
    lat = res.latency_percentiles((50.0,))
    assert lat.shape == (3, 2, 2, 1)
    ff, ss = lat[0, 0, 1, 0], lat[2, 0, 1, 0]
    assert np.isfinite(ff) and np.isfinite(ss) and ff < ss
    w = res.wer_surface()
    np.testing.assert_array_equal(res.wer(1, 2), w[2, 1])
    assert res.pulse_for_wer(0.75, v_index=1) == max(
        res.pulse_for_wer(0.75, v_index=1, corner_index=ci)
        for ci in range(3))


def test_variation_campaign_matches_reference(var_result, shared_tilts):
    grid, got = var_result
    want = jrun_campaign(jparams.AFMTJ_PARAMS, _ref_grid(grid),
                         backend="ref", use_cache=False)
    assert got.crossing_time.shape == want.crossing_time.shape
    _check_crossings(got.crossing_time / grid.dt,
                     want.crossing_time / grid.dt)
    moved = (np.abs(got.crossing_time - want.crossing_time)
             > 0.5 * grid.dt).sum(axis=-1)
    dw = np.abs(got.wer_surface() - want.wer_surface())
    assert (dw <= moved[..., None] / grid.n_samples + 1e-12).all()


def test_corner_count_and_values_are_launch_data(monkeypatch):
    """Every variation campaign is one launch of the variation instance;
    3 and 4 corners land in the same total bucket (4,096 lanes), and new
    corner values or seeds change nothing but the data."""
    calls = []

    def fake_kernel(state, p, dt, n, thr, **kw):
        calls.append((state.shape[1], kw["lane_params"] is not None, n))
        out = state.clone()
        out[7] = float(n)
        return out

    monkeypatch.setattr(tengine, "llg_rk4_kernel", fake_kernel)
    grid = TGrid(**VAR_GRID, variation=SPEC3)
    spec_b = VariationSpec(corners=(
        dataclasses.replace(CORNER_SS, alpha_factor=1.3, sigma_volume=0.1),
        CORNER_TT, CORNER_FF), seed=17)
    spec_c = VariationSpec(corners=(CORNER_TT, CORNER_SS, CORNER_FF,
                                    dataclasses.replace(CORNER_SS, name="sf",
                                                        r_factor=1.3)))
    for g in (grid, dataclasses.replace(grid, variation=spec_b, seed=3),
              dataclasses.replace(grid, variation=spec_c)):
        r = run_campaign(AFMTJ_PARAMS, g, use_cache=False, device="cpu")
        assert r.crossing_time.shape[0] == g.n_corners
    assert calls == [(4096, True, 2048)] * 3


def test_nominal_corner_statistically_matches_legacy_engine():
    """An all-nominal variation campaign integrates through the per-lane
    rows (other rounding than the scalar constants), so it agrees with
    the nominal engine statistically: WER within 0.2 (~3 sigma at 64
    samples)."""
    grid = TGrid(**dict(VAR_GRID, n_samples=64), variation=VariationSpec())
    r_var = run_campaign(AFMTJ_PARAMS, grid, use_cache=False, device="cpu")
    r_leg = run_campaign(AFMTJ_PARAMS,
                         dataclasses.replace(grid, variation=None),
                         use_cache=False, device="cpu")
    assert r_var.crossing_time.shape == (1,) + r_leg.crossing_time.shape
    w_var, w_leg = r_var.wer_surface()[0], r_leg.wer_surface()
    np.testing.assert_allclose(w_var, w_leg, atol=0.2)
    assert w_var[:, 0, 0].min() > 0.8 and w_leg[:, 0, 0].min() > 0.8


def test_cache_keys_on_the_spec_and_checks_the_full_shape(tmp_path):
    grid = TGrid(voltages=(1.2,), pulse_widths=(40e-12,), n_samples=8,
                 seed=0)
    one_tt = dataclasses.replace(grid, variation=VariationSpec())
    backend = "cpu-plain"
    assert tcache.KERNEL_VERSION == 2
    k_nom = tcache.campaign_key(AFMTJ_PARAMS, grid, backend)
    k_tt = tcache.campaign_key(AFMTJ_PARAMS, one_tt, backend)
    assert k_nom != k_tt
    d = str(tmp_path)
    r1 = run_campaign(AFMTJ_PARAMS, one_tt, cache_dir=d, device="cpu")
    r2 = run_campaign(AFMTJ_PARAMS, one_tt, cache_dir=d, device="cpu")
    assert not r1.from_cache and r2.from_cache and r2.n_launches == 0
    assert r2.crossing_time.shape == (1, 1, 1, 8)
    np.testing.assert_array_equal(r1.crossing_time, r2.crossing_time)
    # an entry of the nominal shape at the variation key is a miss
    tcache.store(k_tt, r1.crossing_time[0], header={}, cache_dir=d)
    assert not run_campaign(AFMTJ_PARAMS, one_tt, cache_dir=d,
                            device="cpu").from_cache
    # and the nominal grid never reads the one-corner entry
    assert not run_campaign(AFMTJ_PARAMS, grid, cache_dir=d,
                            device="cpu").from_cache


# --- consumers ----------------------------------------------------------------
def test_run_ensemble_reference_rows_match_reference():
    """The reference's own ``LaneRows`` (kernel rows and sigma) through
    both sides' ``run_ensemble``: crossing rows within C3's bound."""
    jp = jparams.AFMTJ_PARAMS
    spec = _ref_spec(VariationSpec(corners=(CORNER_CASES["ss_d2d"],),
                                   seed=4))
    cells, dt, n = 400, 0.1e-12, 1200
    rows = spec.lane_rows(jp, spec.corners[0], cells, dt)
    rng = np.random.default_rng(2)
    th = (np.abs(rng.standard_normal(cells)) * rows.theta0 + 0.01
          ).astype(np.float32)
    ph = rng.uniform(0.0, 6.28, cells).astype(np.float32)
    m0 = np.array(jax.vmap(lambda t, f: jllg.initial_state(jp, t, f))(th, ph))
    v = np.linspace(0.9, 1.4, cells).astype(np.float32)
    kw = dict(seed=6, chunk=64, lane_params=rows.kernel_rows,
              sigma_lanes=rows.sigma)
    want = jrun_ensemble(jp, m0, v, dt, n, backend="ref", **kw)
    got = run_ensemble(AFMTJ_PARAMS, torch.from_numpy(m0),
                       torch.from_numpy(v), dt, n, device="cpu", **kw)
    assert want.switched.sum() > 100
    _check_crossings(got.crossing_steps, want.crossing_steps)


def test_run_ensemble_lane_params_drive_scale():
    """g_scale 0 removes the STT drive: no lane crosses; at 1 (same
    seeds) the 1.2 V lanes do."""
    p = AFMTJ_PARAMS
    n = 128
    m0 = tdevice.llg.initial_state(p, torch.full((n,), 0.1),
                                   torch.full((n,), 0.2))
    v = torch.full((n,), 1.2)
    lp_on = np.stack([np.full(n, p.alpha), np.full(n, p.b_aniso),
                      np.ones(n)]).astype(np.float32)
    lp_off = lp_on.copy()
    lp_off[2] = 0.0
    kw = dict(dt=0.1e-12, n_steps=1200, seed=4, chunk=64, device="cpu")
    assert run_ensemble(p, m0, v, lane_params=lp_on, **kw).switched.any()
    assert not run_ensemble(p, m0, v, lane_params=lp_off,
                            **kw).switched.any()


def test_mtj_variation_campaign_matches_reference(shared_tilts):
    """The single-sublattice kernel honours the variation rows too: the
    slow corner's WER at a marginal pulse exceeds the fast corner's on the
    same streams, and the crossing rows match the reference's."""
    grid = TGrid(voltages=(2.0,), pulse_widths=(500e-12,),
                 temperatures=(300.0,), n_samples=32, dt=0.2e-12, seed=1,
                 variation=VariationSpec(corners=(CORNER_FF, CORNER_SS)))
    got = run_campaign(MTJ_PARAMS, grid, use_cache=False, device="cpu")
    want = jrun_campaign(jparams.MTJ_PARAMS, _ref_grid(grid), backend="ref",
                         use_cache=False)
    w = got.wer_surface()
    assert w.shape == (2, 1, 1, 1)
    assert w[1, 0, 0, 0] > w[0, 0, 0, 0]
    _check_crossings(got.crossing_time / grid.dt,
                     want.crossing_time / grid.dt)
