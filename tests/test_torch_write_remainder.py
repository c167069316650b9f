"""The port's write-error rate against the JAX reference on the CPU:
``write_error_rate`` (one campaign launch) and ``write_error_rate_scan``
(the per-step baseline).  ``test_torch_write_surface.py`` holds the rest
of the write-path remainder (``program_bits``, ``write_surface``,
``write_energy_accuracy_surface``).

Shared draws: the scan baseline takes the reference's threefry draws
(``scan_draws`` replaced: tilt, phase and every step's Brown normals); the
campaign takes the reference's tilt draws (``grid.tilt_draws`` replaced)
against the reference's plain campaign backend.

Tolerances:

* switched sets and campaign WERs: ROADMAP C3's bound — XLA:CPU fuses
  multiply-adds and the port does not, so at most 1 lane in 512 crosses
  on the other side of the pulse end (at least 1 lane per comparison);
* ``write_error_rate`` against the independently drawn scan: the
  reference's own statistical bounds (``tests/test_campaign.py``: 0.15 at
  AFMTJ 200 ps, 64 samples; 0.25 at MTJ 1400 ps, 48 samples).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign.grid as jgrid_mod
from repro.core import llg as jllg, montecarlo as jmc
from repro.core.device import a_j_from_voltage as j_aj
from repro.core.device import thermal_theta0 as j_theta0
from repro.core.integrator import rk4_step as j_rk4
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ, MTJ_PARAMS as J_MTJ
import repro_torch.campaign.grid as tgrid_mod
from repro_torch.core import montecarlo as tmc
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS

PARAMS = {"afmtj": (J_AFMTJ, AFMTJ_PARAMS), "mtj": (J_MTJ, MTJ_PARAMS)}
# (kind, V, pulse, samples, dt) of the reference's WER statistics tests
WER_POINTS = [("afmtj", 1.0, 200e-12, 64, 0.1e-12, 0.15),
              ("mtj", 1.0, 1400e-12, 48, 0.2e-12, 0.25)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _c3_lanes(n: int) -> int:
    """ROADMAP C3: at most 1 lane in 512 apart, at least 1."""
    return max(1, n // 512)


# --- the scan baseline on the reference's threefry draws -----------------------

def _jax_scan_draws(seed, n_samples, n_steps, n_sub):
    """``write_error_rate_scan``'s draws (``core/montecarlo.py:88-99``)."""
    def one(key):
        k0, k1, kr = jax.random.split(key, 3)
        normals = jax.vmap(lambda sk: jax.random.normal(sk, (n_sub, 3)))(
            jax.random.split(kr, n_steps))
        return (jax.random.normal(k0),
                jax.random.uniform(k1, maxval=2 * jnp.pi), normals)

    z, ph, normals = jax.vmap(one)(
        jax.random.split(jax.random.PRNGKey(seed), n_samples))
    return _t(z), _t(ph), _t(normals).transpose(0, 1).contiguous()


def _ref_switched(p, voltage, n_samples, dt, n_steps, seed):
    """Per-sample switched flags of the reference's scan body, built from
    the reference's own functions (its public function returns only the
    mean, which the test holds this replica to)."""
    sigma = jmc.thermal_sigma(p, dt)

    def one(key):
        k0, k1, kr = jax.random.split(key, 3)
        th = jnp.abs(jax.random.normal(k0)) * j_theta0(p) + 0.01
        ph = jax.random.uniform(k1, maxval=2 * jnp.pi)
        m0 = jllg.initial_state(p, theta0=th, phi0=ph)

        def body(carry, step_key):
            m, sw = carry
            aj = j_aj(voltage, m, p)
            b_th = sigma * jax.random.normal(step_key, m.shape)
            m = j_rk4(lambda mm, tt: jllg.llg_rhs(mm, p, aj, b_th), m, 0.0, dt)
            return (m, jnp.logical_or(sw, jllg.order_parameter_z(m) < -0.9)), None

        (_, sw), _ = jax.lax.scan(body, (m0, jnp.asarray(False)),
                                  jax.random.split(kr, n_steps))
        return sw

    keys = jax.random.split(jax.random.PRNGKey(seed), n_samples)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


@pytest.mark.parametrize("kind,v,pulse,n,dt,_", WER_POINTS)
def test_scan_matches_reference_switched_set(kind, v, pulse, n, dt, _,
                                             monkeypatch):
    jp, tp = PARAMS[kind]
    monkeypatch.setattr(tmc, "scan_draws", _jax_scan_draws)
    n_steps = int(pulse / dt)
    want = _ref_switched(jp, v, n, dt, n_steps, seed=0)
    assert 1.0 - want.mean() == pytest.approx(float(
        jmc.write_error_rate_scan(jp, v, pulse, n_samples=n, dt=dt)),
        abs=1e-7)
    got = tmc.scan_switched(tp, v, pulse, n_samples=n, dt=dt, device="cpu")
    assert 0 < want.sum() < n               # both outcomes present
    assert (got.numpy() != want).sum() <= _c3_lanes(n)
    wer = tmc.write_error_rate_scan(tp, v, pulse, n_samples=n, dt=dt,
                                    device="cpu")
    assert wer == 1.0 - got.float().mean().item()


@pytest.mark.parametrize("kind,v,pulse,n,dt,bound", WER_POINTS)
def test_engine_agrees_with_scan_statistics(kind, v, pulse, n, dt, bound):
    """The reference's ``test_engine_agrees_with_scan_statistics`` /
    ``test_fm_campaign_matches_scan_statistics`` on the port: two RNG
    implementations of the same physics agree within Monte-Carlo error."""
    _, tp = PARAMS[kind]
    w_engine = tmc.write_error_rate(tp, v, pulse, n_samples=n, dt=dt,
                                    device="cpu")
    w_scan = tmc.write_error_rate_scan(tp, v, pulse, n_samples=n, dt=dt,
                                       device="cpu")
    assert abs(w_engine - w_scan) < bound, (w_engine, w_scan)


def _ref_grid(grid):
    return jgrid_mod.CampaignGrid(
        voltages=grid.voltages, pulse_widths=grid.pulse_widths,
        temperatures=grid.temperatures, n_samples=grid.n_samples,
        dt=grid.dt, seed=grid.seed, switch_threshold=grid.switch_threshold)


def test_write_error_rate_matches_reference(monkeypatch):
    """One campaign launch each, on shared tilts: the WER within C3."""
    def tilts(grid, t_index, cells, device):
        zs, ph = jgrid_mod._plane_tilt_draws(_ref_grid(grid), t_index, cells)
        return np.array(zs), np.array(ph)

    monkeypatch.setattr(tgrid_mod, "tilt_draws", tilts)
    n = 64
    ref = jmc.write_error_rate(J_AFMTJ, 1.0, 200e-12, n_samples=n,
                               backend="ref")
    got = tmc.write_error_rate(AFMTJ_PARAMS, 1.0, 200e-12, n_samples=n,
                               device="cpu")
    assert 0.0 < ref < 1.0
    assert abs(got - ref) <= _c3_lanes(n) / n + 1e-12


