"""The port's write-path remainder against the JAX reference on the CPU:
``program_bits``, ``write_surface`` and ``write_energy_accuracy_surface``
(``test_torch_write_remainder.py`` holds the write-error rate).

Shared draws: the write-verify rounds take the reference's tilt draws
(``grid.tilt_draws`` replaced) against the reference's plain campaign
backend; the decode projection and the write-BER masks are the
reference's ``jax.random`` draws (``projection_draws`` /
``write_ber_masks`` replaced).

Tolerances: write-verify attempts, success, error maps, latencies and
attempt budgets equal (measured); per-cell energies rtol 1e-3, as
``test_torch_write_path.py`` (crossing times may differ by C3's 1-2
steps); the decode projection's nmse at the same write BER rtol 1e-5 and
its cosine rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign.engine as jengine
import repro.campaign.grid as jgrid_mod
import repro.imc.write_path as jwp
from repro.configs.registry import ARCHS as J_ARCHS
from repro.imc import mapping as jmapping
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.configs.registry import get_arch
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import mapping as tmapping
from repro_torch.imc import write_path as twp


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_grid(grid):
    return jgrid_mod.CampaignGrid(
        voltages=grid.voltages, pulse_widths=grid.pulse_widths,
        temperatures=grid.temperatures, n_samples=grid.n_samples,
        dt=grid.dt, seed=grid.seed, switch_threshold=grid.switch_threshold)


@pytest.fixture
def shared_rounds(monkeypatch):
    """Port: the reference's tilt draws.  Reference: its plain campaign
    backend.  Both: campaigns memoized in memory on (params, grid), the
    on-disk cache's behaviour without the disk (write-verify rounds of the
    same seed and survivors repeat across attempt budgets)."""
    def tilts(grid, t_index, cells, device):
        zs, ph = jgrid_mod._plane_tilt_draws(_ref_grid(grid), t_index, cells)
        return np.array(zs), np.array(ph)

    memo = {}
    run_j = jengine.run_campaign
    run_t = twp.run_campaign

    def ref(p, grid, **kw):
        key = ("j", p, grid)
        if key not in memo:
            memo[key] = run_j(p, grid, backend="ref", use_cache=False)
        return memo[key]

    def port(p, grid, **kw):
        key = ("t", p, grid)
        if key not in memo:
            memo[key] = run_t(p, grid, use_cache=False, device="cpu")
        return memo[key]

    monkeypatch.setattr(tgrid_mod, "tilt_draws", tilts)
    monkeypatch.setattr(jwp, "run_campaign", ref)
    monkeypatch.setattr(twp, "run_campaign", port)
    yield memo


def _same_writes(got, ref):
    assert got.pulse == ref.pulse and got.rounds == ref.rounds
    np.testing.assert_array_equal(got.attempts, ref.attempts)
    np.testing.assert_array_equal(got.success, ref.success)
    np.testing.assert_allclose(got.energy, ref.energy, rtol=1e-3)
    np.testing.assert_array_equal(got.latency, ref.latency)
    np.testing.assert_array_equal(got.retry_histogram(),
                                  ref.retry_histogram())


def test_program_bits_matches_reference(shared_rounds):
    rng = np.random.default_rng(4)
    target = rng.integers(0, 2, (16, 24))
    current = np.where(rng.uniform(size=target.shape) < 0.3, target,
                       rng.integers(0, 2, target.shape))
    kw = dict(pulse=120e-12, max_attempts=2, seed=5)
    ref, ref_map = jwp.program_bits(
        target, "afmtj", jwp.WritePolicy(backend="ref", **kw), current)
    got, got_map = twp.program_bits(target, "afmtj", twp.WritePolicy(**kw),
                                    current, device="cpu")
    _same_writes(got, ref)
    np.testing.assert_array_equal(got_map, ref_map)
    flip = target != current
    assert got.attempts.size == flip.sum()
    assert got_map.sum() == (~got.success).sum() > 0
    assert not got_map[~flip].any()
    with pytest.raises(ValueError):
        twp.program_bits(np.zeros(4, int), device="cpu")


def test_write_surface_matches_reference(shared_rounds):
    kw = dict(voltages=(0.8, 1.2), pulses=(120e-12,),
              temperatures=(300.0, 375.0), n_cells=64)
    ref = jwp.write_surface("afmtj", policy=jwp.WritePolicy(
        backend="ref", max_attempts=1), **kw)
    got = twp.write_surface("afmtj", policy=twp.WritePolicy(max_attempts=1),
                            device="cpu", **kw)
    for f in ("kind", "voltages", "pulses", "temperatures"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("residual_ber", "attempts_mean", "latency_mean"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.energy_mean, ref.energy_mean, rtol=1e-3)
    assert got.residual_ber.shape == (2, 2, 1)
    # a harder drive leaves no more stale cells
    assert (got.residual_ber[:, 0] >= got.residual_ber[:, 1]).all()
    assert got.residual_ber.max() > 0.0


def _jax_ber_masks(seed, ber, shape, device):
    kber = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EB)
    kb1, kb2 = jax.random.split(kber)
    shape = tuple(shape)
    return (_t(jax.random.bernoulli(kb1, ber, shape)).to(device),
            _t(jax.random.bernoulli(kb2, ber, shape)).to(device))


def _jax_projection_draws(seed, k, n, batch):
    kw, kx = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(kw, (k, n), jnp.float32) / (k ** 0.5)
    x = jax.random.normal(kx, (batch, k), jnp.float32)
    return _t(w), _t(x)


def test_write_energy_accuracy_surface_matches_reference(shared_rounds,
                                                         monkeypatch):
    monkeypatch.setattr(tap, "write_ber_masks", _jax_ber_masks)
    monkeypatch.setattr(tmapping, "projection_draws", _jax_projection_draws)
    targets = (3e-1, 1e-1, 1e-2, 1e-4)
    kw = dict(wer_targets=targets, n_cells=64, cap_k=64, cap_n=64,
              batch=4)
    ref = jmapping.write_energy_accuracy_surface(
        J_ARCHS["gemma2-2b"], policy=jwp.WritePolicy(
            pulse=150e-12, backend="ref"), **kw)
    got = tmapping.write_energy_accuracy_surface(
        get_arch("gemma2-2b"), policy=twp.WritePolicy(pulse=150e-12),
        device="cpu", **kw)
    assert set(got) == set(ref) == set(targets)
    budgets = [got[t].attempts_budget for t in targets]
    assert budgets == sorted(budgets) and budgets[-1] > budgets[0]
    for t in targets:
        g, r = got[t], ref[t]
        assert g.attempts_budget == r.attempts_budget, t
        assert g.write_ber == r.write_ber, t
        assert g.attempts_mean == r.attempts_mean, t
        assert g.t_write_mean == r.t_write_mean, t
        np.testing.assert_allclose(g.e_write_bit, r.e_write_bit, rtol=1e-3)
        assert (g.report.m, g.report.k, g.report.n) == (r.report.m,
                                                        r.report.k,
                                                        r.report.n)
        np.testing.assert_allclose(g.report.nmse, r.report.nmse, rtol=1e-5)
        np.testing.assert_allclose(g.report.cosine, r.report.cosine,
                                   rtol=1e-6)
