"""The write path's process corners (DESIGN.md §9) against the JAX
reference on the CPU: ``write_verify_corners``, ``measured_write_timings
(variation=)`` and ``wer_margined_pulse(variation=)``.

Shared inputs: every round's Boltzmann tilts are the reference's
``jax.random`` draws (the port's ``grid.tilt_draws`` is handed them, and
each corner write-verify round draws through it); the reference runs its
plain (``ref``) campaign backend without its cache.

Bounds: attempts, successes and rounds equal (measured: equal); crossing
times within 2 steps (C3), energies rtol 1e-3 (they follow the crossings
and the 2e-6 spread of the conductance factors); the margined pulse the
same rung (measured: the same).
"""
import dataclasses

import numpy as np
import pytest

import repro.campaign.engine as jengine
import repro.campaign.grid as jgrid_mod
import repro.imc.write_path as jwp
from repro.campaign import CampaignGrid as JGrid
from repro.core import params as jparams
from repro.imc import write_margin as jwm
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.core.params import CORNER_FF, CORNER_SS, VariationSpec
from repro_torch.imc import write_margin as twm, write_path as twp

ROW7_STEPS = 2
LADDER = tuple(x * 1e-12 for x in (120, 160, 200, 250, 300))


def _ref_spec(spec):
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
def shared_round_draws(monkeypatch):
    run = jengine.run_campaign

    def run_ref(p, grid, **kw):
        kw.update(backend="ref", use_cache=False)
        return run(p, grid, **kw)

    monkeypatch.setattr(tgrid_mod, "tilt_draws", _shared_tilts)
    monkeypatch.setattr(jengine, "run_campaign", run_ref)
    for f in (jwm.wer_margined_pulse, twm.wer_margined_pulse):
        f.cache_clear()
    yield
    for f in (jwm.wer_margined_pulse, twm.wer_margined_pulse):
        f.cache_clear()


def test_write_verify_corners_match_reference(shared_round_draws):
    """Slow-corner devices retry more (paired per cell, shared D2D draws
    and round streams); attempts, successes and rounds equal the
    reference's."""
    spec = VariationSpec(corners=(CORNER_FF, CORNER_SS))
    pol = twp.WritePolicy(v_write=1.0, pulse=110e-12, max_attempts=3, seed=3,
                          use_cache=False)
    jpol = jwp.WritePolicy(v_write=1.0, pulse=110e-12, max_attempts=3,
                           seed=3, use_cache=False, backend="ref")
    got = twp.write_verify_corners("afmtj", 192, pol, spec, device="cpu")
    want = jwp.write_verify_corners("afmtj", 192, jpol, _ref_spec(spec))
    assert set(got) == set(want) == {"ff", "ss"}
    for name in want:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(g.attempts, w.attempts)
        np.testing.assert_array_equal(g.success, w.success)
        assert g.rounds == w.rounds
        np.testing.assert_allclose(g.crossing_time, w.crossing_time,
                                   atol=ROW7_STEPS * g.dt * 1.0001)
        np.testing.assert_allclose(g.energy, w.energy, rtol=1e-3)
    assert got["ss"].attempts_mean > got["ff"].attempts_mean
    assert got["ss"].rounds >= got["ff"].rounds >= 1
    assert got["ss"].energy_mean() > 0 and got["ff"].energy_mean() > 0


def test_write_verify_takes_one_corner():
    pol = twp.WritePolicy(pulse=110e-12, use_cache=False,
                          variation=VariationSpec(corners=(CORNER_FF,
                                                           CORNER_SS)))
    with pytest.raises(ValueError, match="one corner"):
        twp.write_verify("afmtj", 8, pol, device="cpu")
    with pytest.raises(ValueError, match="VariationSpec"):
        twp.write_verify_corners("afmtj", 8, twp.WritePolicy(),
                                 device="cpu")


def test_measured_write_timings_passes_the_corner(monkeypatch):
    """``variation`` reaches the write-verify policy, and the timings are
    the reduction of its result."""
    seen = []
    real = twp.write_verify

    def spy(kind, n_cells, policy, device=None):
        seen.append(policy)
        return real(kind, n_cells, dataclasses.replace(policy, max_attempts=1),
                    device)

    monkeypatch.setattr(twp, "write_verify", spy)
    spec = VariationSpec(corners=(CORNER_SS,))
    twp.measured_write_timings.cache_clear()
    mw = twp.measured_write_timings("afmtj", cols=16, n_rows=2,
                                    pulse=60e-12, use_cache=False,
                                    variation=spec, device="cpu")
    twp.measured_write_timings.cache_clear()
    assert [p.variation for p in seen] == [spec]
    assert mw.pulse == 60e-12 and mw.attempts_mean == 1.0
    assert 0.0 <= mw.residual_ber <= 1.0


def test_wer_margined_pulse_covers_process_corners(shared_round_draws):
    """The corner-margined pulse is the worst case over (corner x T): at
    least the nominal one, from one fused launch, and the reference's
    rung with shared tilts."""
    kw = dict(v_write=1.0, wer_target=5e-2, n_samples=64, use_cache=False,
              ladder=LADDER)
    spec = VariationSpec(corners=(CORNER_FF, CORNER_SS))
    nominal = twm.wer_margined_pulse("afmtj", device="cpu", **kw)
    ranged = twm.wer_margined_pulse("afmtj", variation=spec, device="cpu",
                                    **kw)
    assert ranged >= nominal
    assert ranged == jwm.wer_margined_pulse("afmtj",
                                            variation=_ref_spec(spec), **kw)
