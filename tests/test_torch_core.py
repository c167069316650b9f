"""The port's ``core`` readout, integrator and write sweep against the JAX
reference on the CPU, on shared inputs.

Bounds (measured values in brackets):

* ``tmr_ratio``, ``read_margin``: Python floats, equal to rtol 1e-12;
  ``resistance``, ``simulate_read``, ``neel_vector``, ``net_moment``:
  float32, rtol 1e-6 [equal];
* ``integrate_fixed`` (400 steps of 0.1 ps, three lanes): constant drive
  through a reversal, a ramp, and thermal (the reference's threefry
  normals handed over through numpy): the trajectory and final state
  within atol 5e-5 [1.0e-5 in the reversal, 2.5e-6 thermal, 6.7e-7 ramp],
  t_switch within one step [equal], energy rtol 1e-5 [<= 3e-7]: the
  reference traces dt and folds dt/6 in float32 and XLA:CPU fuses
  multiply-adds (ROADMAP C3);
* ``integrate_adaptive`` on ``tests/test_llg_physics.py``'s case (20 ps
  at a_J = 0.1 T, rtol 1e-8): final state within atol 5e-5 of the
  reference's [1.6e-7] and within the reference test's atol 1e-4 of
  0.1 ps fixed stepping;
* ``write_sweep`` over the quickstart's four voltages at a horizon just
  past the 1 V switch (3,000 AFMTJ steps of 0.05 ps, 14,000 MTJ steps of
  0.1 ps): t_switch within two steps (C3) [equal], energy rtol 1e-5
  [<= 4.2e-7], switched equal (0.5 and 0.8 V do not switch by then);
* ``write_sweep`` over a batch of voltages equal, bit for bit, to
  ``simulate_write`` run per voltage (batch invariance of
  ``ref_llg_write``), both write directions;
* ``simulate_write`` per voltage equal, bit for bit, to the outputs of the
  eager per-step loop it ran before the loop moved into
  ``kernels/ref.ref_llg_write`` (recorded from ``core/device.py`` at git
  commit 7bf5f6a, float32 values written as hex).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device as jdevice, integrator as jint
from repro.core import llg as jllg, tmr as jtmr
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ, MTJ_PARAMS as J_MTJ
from repro_torch import core as tcore
from repro_torch.core import device as tdevice, integrator as tint
from repro_torch.core import llg as tllg, tmr as ttmr
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.kernels import ref
from repro_torch.kernels.llg_write import llg_write_kernel

PARAMS = {"afmtj": (J_AFMTJ, AFMTJ_PARAMS), "mtj": (J_MTJ, MTJ_PARAMS)}
F32_RTOL = 1e-6
STATE_ATOL = 5e-5
ENERGY_RTOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _states(kind, up):
    jp, tp = PARAMS[kind]
    return (jllg.initial_state(jp, theta0=0.2, phi0=0.3, up=up),
            tllg.initial_state(tp, theta0=0.2, phi0=0.3, up=up, device="cpu"))


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_readout_matches_reference(kind):
    jp, tp = PARAMS[kind]
    np.testing.assert_allclose(ttmr.tmr_ratio(tp), jtmr.tmr_ratio(jp),
                               rtol=1e-12)
    np.testing.assert_allclose(ttmr.read_margin(tp, 0.2),
                               jtmr.read_margin(jp, 0.2), rtol=1e-12)
    for up in (True, False):
        jm, tm = _states(kind, up)
        np.testing.assert_allclose(_np(ttmr.resistance(tm, tp)),
                                   _np(jtmr.resistance(jm, jp)),
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(_np(tllg.neel_vector(tm)),
                                   _np(jllg.neel_vector(jm)), rtol=F32_RTOL)
        np.testing.assert_allclose(_np(tllg.net_moment(tm)),
                                   _np(jllg.net_moment(jm)), rtol=F32_RTOL,
                                   atol=1e-12)
        for got, want in zip(tdevice.simulate_read(tp, tm),
                             jdevice.simulate_read(jp, jm)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=F32_RTOL)


def test_tmr_validation_mirrors_reference():
    """``tests/test_device.py::test_tmr_validation`` on the port."""
    assert abs(tcore.tmr_ratio(AFMTJ_PARAMS) - 0.8) < 1e-9
    m_p = tcore.initial_state(AFMTJ_PARAMS, up=True, device="cpu")
    m_ap = tcore.initial_state(AFMTJ_PARAMS, up=False, device="cpu")
    i_p, r_p = tcore.simulate_read(AFMTJ_PARAMS, m_p)
    i_ap, r_ap = tcore.simulate_read(AFMTJ_PARAMS, m_ap)
    assert float(i_p) > float(i_ap)
    assert float(r_ap) / float(r_p) == pytest.approx(1.8, rel=1e-3)


# the reference's integrate_fixed with the function-valued and the noise
# switch arguments static (its own jit traces them, which a Python callable
# and the `thermal_sigma > 0` branch do not survive)
_J_FIXED = jax.jit(jint.integrate_fixed.__wrapped__,
                   static_argnames=("n_steps", "record_trajectory",
                                    "thermal_sigma", "conductance_fn"))
N_FIXED, DT_FIXED = 400, 0.1e-12


def _j_conductance(m):
    return jtmr.conductance(m, J_AFMTJ)


@pytest.mark.parametrize("case", ["constant", "ramp", "thermal"])
def test_integrate_fixed_matches_reference(case):
    jm0, tm0 = _states("afmtj", True)
    jm0 = jnp.stack([jm0] * 3)
    tm0 = torch.stack([tm0] * 3)
    a_j = (0.4 if case != "ramp" else
           np.linspace(0.0, 0.6, N_FIXED, dtype=np.float32))
    kw = dict(dt=DT_FIXED, n_steps=N_FIXED, voltage=1.0,
              record_trajectory=True)
    t_kw = {}
    if case == "thermal":
        kw["thermal_sigma"] = 0.05
        keys = jax.random.split(jax.random.PRNGKey(0), N_FIXED)
        normals = jax.vmap(lambda k: jax.random.normal(k, jm0.shape))(keys)
        t_kw["normals"] = torch.tensor(np.asarray(normals))
    want, j_traj = _J_FIXED(jm0, J_AFMTJ, jnp.asarray(a_j),
                            conductance_fn=_j_conductance, **kw)
    got, t_traj = tint.integrate_fixed(
        tm0, AFMTJ_PARAMS, torch.as_tensor(a_j),
        conductance_fn=lambda m: ttmr.conductance(m, AFMTJ_PARAMS), **kw,
        **t_kw)
    assert t_traj.shape == (N_FIXED, 3, 2, 3)
    np.testing.assert_allclose(_np(got.final_m), _np(want.final_m),
                               atol=STATE_ATOL)
    np.testing.assert_allclose(_np(t_traj), _np(j_traj), atol=STATE_ATOL)
    np.testing.assert_array_equal(_np(got.switched), _np(want.switched))
    np.testing.assert_allclose(_np(got.t_switch), _np(want.t_switch),
                               atol=DT_FIXED * 1.0001)
    np.testing.assert_allclose(_np(got.energy), _np(want.energy),
                               rtol=ENERGY_RTOL)
    if case == "constant":
        assert bool(got.switched.all())


def test_integrate_fixed_draws_from_a_generator():
    """The thermal normals are the caller's tensor, here drawn with
    ``torch.randn`` from a seeded ``torch.Generator``."""
    _, tm0 = _states("afmtj", True)
    kw = dict(dt=DT_FIXED, n_steps=20, thermal_sigma=0.05)
    with pytest.raises(ValueError, match="normals"):
        tint.integrate_fixed(tm0, AFMTJ_PARAMS, 0.1, **kw)
    with pytest.raises(ValueError, match="normals"):
        tint.integrate_fixed(tm0, AFMTJ_PARAMS, 0.1,
                             normals=torch.zeros(19, 2, 3), **kw)
    runs = [tint.integrate_fixed(
        tm0, AFMTJ_PARAMS, 0.1, normals=torch.randn(
            (20, *tm0.shape), generator=torch.Generator().manual_seed(7)),
        **kw)[0].final_m for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    quiet = tint.integrate_fixed(tm0, AFMTJ_PARAMS, 0.1, dt=DT_FIXED,
                                 n_steps=20)[0].final_m
    assert not torch.equal(runs[0], quiet)


def test_integrate_adaptive_matches_reference():
    """``tests/test_llg_physics.py::test_adaptive_matches_fixed``'s case."""
    jm0, tm0 = _states("afmtj", True)
    want = jint.integrate_adaptive(jm0, J_AFMTJ, jnp.asarray(0.1), 20e-12,
                                   rtol=1e-8)
    got = tint.integrate_adaptive(tm0, AFMTJ_PARAMS, 0.1, 20e-12, rtol=1e-8)
    np.testing.assert_allclose(_np(got.final_m), _np(want.final_m),
                               atol=STATE_ATOL)
    assert bool(got.switched) == bool(want.switched)
    m = tm0
    for _ in range(200):
        m = tint.rk4_step(lambda mm, tt: tllg.llg_rhs(
            mm, AFMTJ_PARAMS, torch.tensor(0.1)), m, 0.0, 0.1e-12)
    np.testing.assert_allclose(_np(got.final_m), _np(m), atol=1e-4)


SWEEP = {"afmtj": (3000, 0.05e-12), "mtj": (14000, 0.1e-12)}
VOLTAGES = (0.5, 0.8, 1.0, 1.2)


@pytest.mark.parametrize("kind", sorted(SWEEP))
def test_write_sweep_matches_reference(kind):
    jp, tp = PARAMS[kind]
    n, dt = SWEEP[kind]
    want = jdevice.write_sweep(jp, jnp.asarray(VOLTAGES), n_steps=n, dt=dt)
    got = tcore.write_sweep(tp, VOLTAGES, n_steps=n, dt=dt, device="cpu")
    assert got.t_switch.shape == (4,)
    assert got.final_state.shape == (4, tp.n_sublattices, 3)
    np.testing.assert_array_equal(_np(got.switched), _np(want.switched))
    assert _np(got.switched).tolist() == [False, False, True, True]
    ts, tw = _np(got.t_switch), _np(want.t_switch)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(tw))
    fin = np.isfinite(tw)
    np.testing.assert_allclose(ts[fin], tw[fin], atol=2.0001 * dt)
    np.testing.assert_allclose(_np(got.energy), _np(want.energy),
                               rtol=ENERGY_RTOL)


# (kind, voltages, n_steps, dt, down): a horizon past the fast lanes'
# switch, one lane that does not switch, both write directions
BATCHES = [("afmtj", (2.0, 3.0, 4.0), 600, 0.1e-12, True),
           ("mtj", (4.0, 12.0, 20.0), 1200, 0.1e-12, True),
           ("afmtj", (-2.0, -4.0), 600, 0.1e-12, False)]


@pytest.mark.parametrize("kind,volts,n,dt,down", BATCHES)
def test_ref_llg_write_is_batch_invariant(kind, volts, n, dt, down):
    """A batch of voltages gives each lane what a one-voltage run gives."""
    tp = PARAMS[kind][1]
    batch = tdevice.write_sweep(tp, volts, n_steps=n, dt=dt, down=down,
                                device="cpu")
    assert bool(batch.switched.any()) and not bool(batch.switched.all())
    for i, v in enumerate(volts):
        one = tdevice.simulate_write(tp, v, n_steps=n, dt=dt, down=down,
                                     device="cpu")
        for f in ("t_switch", "write_latency", "energy", "switched",
                  "final_state"):
            assert torch.equal(getattr(one, f), getattr(batch, f)[i]), (f, v)


# simulate_write(p, v, n_steps, dt, down=down, device="cpu") of the eager
# per-step loop at BATCHES' cases: (t_switch, write_latency, energy,
# switched, final state row-major), float32 values as hex
EAGER_LOOP = {
    ("afmtj", 2.0, True): (
        "inf", "inf", "0x1.2a453p-43", False,
        ("0x1.eb544ep-1", "0x1.269398p-7", "0x1.1fe094p-2",
         "-0x1.981c06p-1", "-0x1.11a0bep-1", "-0x1.1fe0c8p-2")),
    ("afmtj", 3.0, True): (
        "0x1.67c282p-35", "0x1.67663cp-34", "0x1.0f301cp-42", True,
        ("0x1.fef7d4p-2", "0x1.278814p-3", "-0x1.b5820ap-1",
         "-0x1.f927a4p-2", "-0x1.4d1ddcp-3", "0x1.b5820cp-1")),
    ("afmtj", 4.0, True): (
        "0x1.08c31ap-35", "0x1.36f356p-34", "0x1.a221f8p-42", True,
        ("0x1.0e1d16p-4", "-0x1.c1b64ep-6", "-0x1.feb132p-1",
         "-0x1.3ee7aap-5", "-0x1.ea9dbcp-5", "0x1.feb132p-1")),
    ("mtj", 4.0, True): (
        "inf", "inf", "0x1.e25418p-41", False,
        ("-0x1.55e75p-1", "0x1.750b9cp-5", "0x1.7c65ccp-1")),
    ("mtj", 12.0, True): (
        "0x1.e0461cp-34", "0x1.4ce68ep-33", "0x1.b59ed4p-38", True,
        ("0x1.ec299p-3", "0x1.d9ef28p-3", "-0x1.e2aa8ep-1")),
    ("mtj", 20.0, True): (
        "0x1.20833cp-34", "0x1.d63468p-34", "0x1.b8d104p-37", True,
        ("0x1.516288p-5", "-0x1.affeeap-7", "-0x1.ff8566p-1")),
    ("afmtj", -2.0, False): (
        "inf", "inf", "0x1.558d48p-44", False,
        ("-0x1.26f0c4p-2", "-0x1.a6546ap-3", "-0x1.decca8p-1",
         "0x1.6aa876p-2", "-0x1.efc8bep-8", "0x1.decca2p-1")),
    ("afmtj", -4.0, False): (
        "0x1.ba7166p-35", "0x1.919158p-34", "0x1.4768d2p-42", True,
        ("0x1.08f874p-3", "0x1.219592p-3", "0x1.f6822ap-1",
         "-0x1.7e337cp-3", "0x1.65907ep-5", "-0x1.f6822ap-1")),
}


@pytest.mark.parametrize("kind,v,n,dt,down", [
    (kind, v, n, dt, down) for kind, volts, n, dt, down in BATCHES
    for v in volts])
def test_write_matches_the_eager_loop_it_replaced(kind, v, n, dt, down):
    t_sw, lat, en, switched, state = EAGER_LOOP[(kind, v, down)]
    got = tdevice.simulate_write(PARAMS[kind][1], v, n_steps=n, dt=dt,
                                 down=down, device="cpu")

    def f32(*hexes):
        return torch.tensor([float.fromhex(h) for h in hexes],
                            dtype=torch.float32)

    assert torch.equal(got.t_switch.reshape(1), f32(t_sw))
    assert torch.equal(got.write_latency.reshape(1), f32(lat))
    assert torch.equal(got.energy.reshape(1), f32(en))
    assert bool(got.switched) is switched
    assert torch.equal(got.final_state.reshape(-1), f32(*state))


def test_write_wrapper_runs_the_plain_version_on_cpu():
    m0 = tllg.initial_state(AFMTJ_PARAMS, theta0=0.2, phi0=0.3,
                            device="cpu").expand(2, 2, 3).contiguous()
    v = torch.tensor([1.0, 3.0])
    before = llg_write_kernel.launches
    got = llg_write_kernel(m0, v, AFMTJ_PARAMS, 0.1e-12, 50)
    want = ref.ref_llg_write(m0, v, AFMTJ_PARAMS, 0.1e-12, 50)
    assert llg_write_kernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        llg_write_kernel(m0.to("meta"), v.to("meta"), AFMTJ_PARAMS,
                         0.1e-12, 1)
