"""The port's measured write path against the JAX reference on the CPU:
``write_verify``, ``make_subarray(..., write_percentile=99.0)`` and
``wer_margined_pulse``, with the reference's tilt draws shared (the port's
``grid.tilt_draws`` is handed ``jax.random``'s draws as numpy) and the
reference's plain campaign backend (its default Pallas backend runs in
interpret mode on the CPU, too slow for a test).  Both sides use the
reference's device write characterization for the nominal pulse.

Attempts, success and the derived timings are equal (measured).  Crossing
times may differ by the reversal gap of ``test_torch_llg.py`` (2 steps);
per-cell energies follow them (rtol 1e-3).
"""
import dataclasses

import numpy as np
import pytest

import repro.campaign.engine as jengine
import repro.campaign.grid as jgrid_mod
import repro.imc.write_path as jwp
from repro.circuit import subarray as jsub
from repro.imc import write_margin as jwm
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.circuit import subarray as tsub
from repro_torch.imc import write_margin as twm, write_path as twp


def _close(a, b, rtol):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float):
            np.testing.assert_allclose(x, y, rtol=rtol, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.fixture
def shared_write_characterization(monkeypatch):
    def char(kind, v_write, device=None):
        return jsub._characterize_write(kind, float(v_write))
    monkeypatch.setattr(tsub, "_characterize_write", char)
    twp.nominal_pulse.cache_clear()
    yield
    twp.nominal_pulse.cache_clear()


def _ref_grid(grid):
    return jgrid_mod.CampaignGrid(
        voltages=grid.voltages, pulse_widths=grid.pulse_widths,
        temperatures=grid.temperatures, n_samples=grid.n_samples,
        dt=grid.dt, seed=grid.seed, switch_threshold=grid.switch_threshold)


@pytest.fixture
def shared_draws_and_plain_reference(monkeypatch,
                                     shared_write_characterization):
    """Port: the reference's tilt draws.  Reference: its plain campaign
    backend, no on-disk cache."""
    def tilts(grid, t_index, cells, device):
        zs, ph = jgrid_mod._plane_tilt_draws(_ref_grid(grid), t_index, cells)
        return np.array(zs), np.array(ph)

    run = jengine.run_campaign

    def run_ref(p, grid, **kw):
        kw.update(backend="ref", use_cache=False)
        return run(p, grid, **kw)

    monkeypatch.setattr(tgrid_mod, "tilt_draws", tilts)
    monkeypatch.setattr(jengine, "run_campaign", run_ref)
    monkeypatch.setattr(jwp, "run_campaign", run_ref)
    for f in (jwp.measured_write_timings, jwm.wer_margined_pulse,
              twp.measured_write_timings, twm.wer_margined_pulse):
        f.cache_clear()
    yield
    for f in (jwp.measured_write_timings, jwm.wer_margined_pulse,
              twp.measured_write_timings, twm.wer_margined_pulse):
        f.cache_clear()


@pytest.mark.parametrize("kind,v,pulse", [("afmtj", 1.0, None),
                                          ("mtj", 2.5, 300e-12)])
def test_write_verify_matches_reference(kind, v, pulse,
                                        shared_draws_and_plain_reference):
    pol_j = jwp.WritePolicy(v_write=v, pulse=pulse, backend="ref",
                            use_cache=False, seed=2, max_attempts=4)
    pol_t = twp.WritePolicy(v_write=v, pulse=pulse, use_cache=False, seed=2,
                            max_attempts=4)
    ref = jwp.write_verify(kind, 300, pol_j)
    got = twp.write_verify(kind, 300, pol_t, device="cpu")
    assert got.pulse == ref.pulse and got.dt == ref.dt
    assert ref.rounds >= 2 and got.rounds == ref.rounds
    np.testing.assert_array_equal(got.attempts, ref.attempts)
    np.testing.assert_array_equal(got.success, ref.success)
    np.testing.assert_allclose(got.crossing_time, ref.crossing_time,
                               rtol=0, atol=2 * ref.dt)
    np.testing.assert_allclose(got.energy, ref.energy, rtol=1e-3)
    assert got.single_pulse_wer == ref.single_pulse_wer
    assert got.residual_ber == ref.residual_ber


def test_measured_subarray_matches_reference(shared_draws_and_plain_reference):
    ref = jsub.make_subarray("afmtj", rows=8, cols=8, write_percentile=99.0)
    got = tsub.make_subarray("afmtj", rows=8, cols=8, write_percentile=99.0,
                             device="cpu")
    _close(got.timings, ref.timings, 1e-3)
    assert got.timings.t_write == ref.timings.t_write
    assert got.timings.write_attempts == ref.timings.write_attempts


def test_wer_margined_pulse_matches_reference(shared_draws_and_plain_reference):
    ref = jwm.wer_margined_pulse("afmtj", 1.0, 1e-2, n_samples=64,
                                 use_cache=False)
    got = twm.wer_margined_pulse("afmtj", 1.0, 1e-2, n_samples=64,
                                 use_cache=False, device="cpu")
    assert got == ref
