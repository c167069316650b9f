"""The port's campaign engine against the reference's plain (``ref``)
backend on the CPU, with the reference's Boltzmann tilt draws shared
(``grid.tilt_draws`` monkeypatched to hand over ``jax.random``'s draws as
numpy).  The thermal streams are bit-identical by construction.

Bounds: packing is equal (initial states to 1 float32 ulp: sin/cos come
from different libraries).  Crossing rows are held to the reversal gap
measured in ``test_torch_llg.py`` — XLA:CPU's fused multiply-adds against
the port's separately rounded products — of at most 1% of lanes, by at
most 2 steps (measured here: 1 lane of 512 by 1 step for the AFMTJ grid, 1
lane of 512 by 2 steps for the MTJ grid); WER surfaces may move only by
what those lanes can move and percentiles by at most 2 steps (measured:
equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign.grid as jgrid_mod
from repro.campaign import CampaignGrid as JGrid
from repro.campaign import cache as jcache
from repro.campaign import run_campaign as jrun_campaign
from repro.campaign import run_ensemble as jrun_ensemble
from repro.campaign.grid import pack_campaign as jpack_campaign
from repro.core import llg as jllg
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ, MTJ_PARAMS as J_MTJ
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.campaign import CampaignGrid as TGrid
from repro_torch.campaign import cache as tcache
from repro_torch.campaign import run_campaign as trun_campaign
from repro_torch.campaign import run_ensemble as trun_ensemble
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS

KINDS = {"afmtj": (J_AFMTJ, AFMTJ_PARAMS), "mtj": (J_MTJ, MTJ_PARAMS)}
GRIDS = {
    "afmtj": dict(voltages=(0.8, 1.2), pulse_widths=(100e-12, 150e-12, 200e-12),
                  temperatures=(300.0, 350.0), n_samples=128, dt=0.1e-12,
                  seed=3),
    "mtj": dict(voltages=(2.5, 3.5), pulse_widths=(200e-12, 300e-12, 450e-12),
                temperatures=(300.0, 350.0), n_samples=128, dt=0.2e-12,
                seed=3),
}
ROW7_FRAC, ROW7_STEPS = 0.01, 2     # reversal gap (test_torch_llg.py)


def _ref_grid(grid) -> JGrid:
    return JGrid(voltages=grid.voltages, pulse_widths=grid.pulse_widths,
                 temperatures=grid.temperatures, n_samples=grid.n_samples,
                 dt=grid.dt, seed=grid.seed,
                 switch_threshold=grid.switch_threshold)


def _shared_tilts(grid, t_index, cells, device):
    zs, ph = jgrid_mod._plane_tilt_draws(_ref_grid(grid), t_index, cells)
    return np.array(zs), np.array(ph)


@pytest.fixture
def shared_tilts(monkeypatch):
    monkeypatch.setattr(tgrid_mod, "tilt_draws", _shared_tilts)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pack_campaign_matches_reference(kind, shared_tilts):
    jp, tp = KINDS[kind]
    grid = TGrid(**GRIDS[kind])
    ref = jpack_campaign(_ref_grid(grid), jp)
    got = tgrid_mod.pack_campaign(grid, tp, "cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1.2e-7)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(ref[1]).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[4] == ref[4]
    assert grid.n_steps == _ref_grid(grid).n_steps


def _check_crossings(got_steps, ref_steps):
    d = np.abs(got_steps - ref_steps)
    assert (d > 0.5).mean() <= ROW7_FRAC
    assert d.max() <= ROW7_STEPS + 1e-6


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_run_campaign_matches_reference(kind, shared_tilts, tmp_path):
    jp, tp = KINDS[kind]
    grid = TGrid(**GRIDS[kind])
    ref = jrun_campaign(jp, _ref_grid(grid), backend="ref", use_cache=False)
    got = trun_campaign(tp, grid, use_cache=False, device="cpu")
    assert got.backend == "cpu-plain" and not got.from_cache
    assert got.crossing_time.shape == ref.crossing_time.shape
    _check_crossings(got.crossing_time / grid.dt, ref.crossing_time / grid.dt)
    # WER may move only by the lanes whose crossing step moved
    moved = (np.abs(got.crossing_time - ref.crossing_time) > 0.5 * grid.dt
             ).sum(axis=-1)                               # (T, V)
    dw = np.abs(got.wer_surface() - ref.wer_surface())
    assert (dw <= moved[..., None] / grid.n_samples + 1e-12).all()
    np.testing.assert_allclose(got.latency_percentiles(),
                               ref.latency_percentiles(), rtol=0,
                               atol=ROW7_STEPS * grid.dt)
    for target in (0.3, 0.7):
        for ti in range(2):
            try:
                want = ref.pulse_for_wer(target, t_index=ti)
            except ValueError:
                with pytest.raises(ValueError):
                    got.pulse_for_wer(target, t_index=ti)
                continue
            assert got.pulse_for_wer(target, t_index=ti) == want
    # cache round trip: a second call with the cache on hits the stored entry
    first = trun_campaign(tp, grid, use_cache=True, cache_dir=str(tmp_path),
                          device="cpu")
    again = trun_campaign(tp, grid, use_cache=True, cache_dir=str(tmp_path),
                          device="cpu")
    assert not first.from_cache and again.from_cache
    np.testing.assert_array_equal(again.crossing_time, got.crossing_time)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("chunk", [0, 64])
def test_run_ensemble_matches_reference(kind, chunk):
    jp, tp = KINDS[kind]
    rng = np.random.default_rng(5)
    cells = 300
    th = rng.uniform(0.05, 0.3, cells).astype(np.float32)
    ph = rng.uniform(0.0, 6.28, cells).astype(np.float32)
    m0 = np.array(jax.vmap(lambda t, f: jllg.initial_state(jp, t, f))(th, ph))
    v = rng.uniform(1.0, 1.6, cells).astype(np.float32)
    dt, n = (0.1e-12, 900) if kind == "afmtj" else (0.2e-12, 1600)
    if kind == "mtj":
        v = v * 3.0
    ref = jrun_ensemble(jp, jnp.asarray(m0), jnp.asarray(v), dt, n, seed=9,
                        backend="ref", chunk=chunk)
    got = trun_ensemble(tp, torch.from_numpy(m0), torch.from_numpy(v), dt, n,
                        seed=9, chunk=chunk, device="cpu")
    assert got.backend == "cpu-plain"
    assert ref.switched.sum() > 20
    _check_crossings(got.crossing_steps, ref.crossing_steps)
    np.testing.assert_array_equal(got.final_state[6], ref.final_state[6])


def test_cache_key_and_directory_are_the_ports_own(tmp_path, monkeypatch):
    jp, tp = KINDS["afmtj"]
    grid = TGrid(**GRIDS["afmtj"])
    keys = {tcache.campaign_key(tp, grid, b) for b in ("cuda-kernel", "cpu-plain")}
    ref_keys = {jcache.campaign_key(jp, _ref_grid(grid), b)
                for b in ("pallas", "ref", "cuda-kernel", "cpu-plain")}
    assert len(keys) == 2 and not keys & ref_keys
    monkeypatch.delenv("REPRO_TORCH_CAMPAIGN_CACHE", raising=False)
    assert tcache.default_cache_dir() != type(tcache.default_cache_dir())(
        jcache.DEFAULT_CACHE_DIR)
    monkeypatch.setenv("REPRO_TORCH_CAMPAIGN_CACHE", str(tmp_path))
    assert tcache.default_cache_dir() == tmp_path
    key = next(iter(keys))
    arr = np.arange(6.0).reshape(1, 2, 3)
    tcache.store(key, arr, header={"k": 1})
    np.testing.assert_array_equal(tcache.load(key), arr)
    assert tcache.load("missing") is None
    (tmp_path / "torn.npz").write_bytes(b"not a zip")
    assert tcache.load_arrays("torn") is None
    assert not list(tmp_path.glob("*.tmp"))
    assert dataclasses.asdict(grid)["n_samples"] == 128
