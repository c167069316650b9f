"""Device physics and the plain LLG integrator of the port against the JAX
reference, on shared inputs made with numpy.

Bounds: the reference's own (rows 0-5 within atol 2e-5, row 7 equal —
``tests/test_kernels.py``) over its test horizons (<= 400 steps, no
reversal), and over a full MTJ reversal (3000 steps at 0.2 ps; measured
gap 5e-6).  Across a full AFMTJ reversal (1500 steps at 0.1 ps) the two
float32 trajectories drift further apart: XLA:CPU contracts multiply-add
pairs into fused multiply-adds (``jnp.cross`` is one such fused
computation) while the port rounds every product, as its CUDA kernel does
(built with ``-fmad=false``), and the exchange-driven reversal amplifies
those last-bit differences.  Measured over 8 runs of 512 lanes: at most 1
lane in 512 crosses at another step, by at most 2 steps, and rows 0-5
differ by at most 1.5e-2.  The AFMTJ reversal test holds those measured
bounds (1% of lanes, 2 steps, 3e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llg as jllg, tmr as jtmr
from repro.core.montecarlo import thermal_sigma
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ, MTJ_PARAMS as J_MTJ
from repro.kernels import noise as jnoise, ops as jops, ref as jref
from repro_torch.core import llg as tllg, tmr as ttmr
from repro_torch.core.params import (AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams,
                                     params_from_reference)
from repro_torch.kernels import ops as tops, ref as tref

KINDS = {"afmtj": (J_AFMTJ, AFMTJ_PARAMS), "mtj": (J_MTJ, MTJ_PARAMS)}
ATOL = 2e-5                # tests/test_kernels.py, rows 0-5
AFMTJ_REVERSAL_ATOL = 3e-2     # measured 1.5e-2 across a reversal
AFMTJ_REVERSAL_ROW7_FRAC = 0.01  # measured <= 1 lane in 512
AFMTJ_REVERSAL_ROW7_STEPS = 2    # measured <= 2 steps
RHS_ULP = 4e-7             # ~2 ulp of the largest |dm/dt| (FMA contraction)


def _states(cells, n_sub, vlo, vhi, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.05, 0.4, cells).astype(np.float32)
    ph = rng.uniform(0.0, 6.28, cells).astype(np.float32)
    m1 = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                   np.cos(th)]).astype(np.float32)
    st = np.zeros((8, cells), np.float32)
    st[0:3] = m1
    if n_sub == 2:
        st[3:6] = -m1
    st[6] = np.linspace(vlo, vhi, cells)
    return st


def _unit(rng, shape):
    m = rng.normal(size=shape).astype(np.float32)
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_params_from_reference_round_trip(kind):
    jp, tp = KINDS[kind]
    got = params_from_reference(dataclasses.asdict(jp))
    assert got == tp
    assert dataclasses.asdict(got) == dataclasses.asdict(jp)
    for prop in ("area", "volume", "r_parallel", "r_antiparallel",
                 "stt_prefactor", "thermal_stability"):
        assert getattr(got, prop) == getattr(jp, prop), prop
    with pytest.raises(ValueError):
        params_from_reference({**dataclasses.asdict(jp), "bogus": 1.0})


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("thermal", [False, True])
def test_llg_rhs_elementwise(kind, thermal):
    jp, tp = KINDS[kind]
    rng = np.random.default_rng(1)
    n_sub = jp.n_sublattices
    m = _unit(rng, (2000, n_sub, 3))
    aj = rng.uniform(0.0, 0.05, 2000).astype(np.float32)
    bth = (0.05 * rng.normal(size=m.shape)).astype(np.float32) if thermal else None
    ref = np.asarray(jllg.llg_rhs(jnp.asarray(m), jp, jnp.asarray(aj),
                                  None if bth is None else jnp.asarray(bth)))
    got = tllg.llg_rhs(torch.from_numpy(m), tp, torch.from_numpy(aj),
                       None if bth is None else torch.from_numpy(bth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RHS_ULP * np.abs(ref).max())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_conductance_and_state_helpers(kind):
    jp, tp = KINDS[kind]
    rng = np.random.default_rng(2)
    m = _unit(rng, (500, jp.n_sublattices, 3))
    np.testing.assert_allclose(
        ttmr.conductance(torch.from_numpy(m), tp).numpy(),
        np.asarray(jtmr.conductance(jnp.asarray(m), jp)), rtol=2.4e-7)
    np.testing.assert_array_equal(
        tllg.order_parameter_z(torch.from_numpy(m)).numpy(),
        np.asarray(jllg.order_parameter_z(jnp.asarray(m))))
    np.testing.assert_allclose(
        tllg.initial_state(tp, 0.2, 0.3, device="cpu").numpy(),
        np.asarray(jllg.initial_state(jp, 0.2, 0.3)), atol=1.2e-7)
    mm = m * rng.uniform(0.9, 1.1, (500, jp.n_sublattices, 1)).astype(np.float32)
    np.testing.assert_allclose(tllg.renormalize(torch.from_numpy(mm)).numpy(),
                               np.asarray(jllg.renormalize(jnp.asarray(mm))),
                               atol=1.2e-7)


def _run_both(kind, st, dt, n_steps, thermal=False, chunk=0, budget=None,
              lane_params=None, seed=42):
    jp, tp = KINDS[kind]
    cells = st.shape[1]
    kw_j, kw_t = {}, {}
    if thermal:
        sigma = np.where(np.arange(cells) % 2 == 0, 1.0, 1.5).astype(
            np.float32) * thermal_sigma(jp, dt)
        seeds = np.asarray(jnoise.cell_seeds(seed, cells))
        kw_j = dict(thermal_sigma=jnp.asarray(sigma), seeds=jnp.asarray(seeds),
                    chunk=chunk)
        kw_t = dict(thermal_sigma=torch.from_numpy(sigma),
                    seeds=torch.from_numpy(seeds.view(np.int32)), chunk=chunk)
        if budget is not None:
            kw_j["step_budget"] = jnp.asarray(budget)
            kw_t["step_budget"] = torch.from_numpy(budget)
        if lane_params is not None:
            kw_j["lane_params"] = jnp.asarray(lane_params)
            kw_t["lane_params"] = torch.from_numpy(lane_params)
    ref = np.asarray(jax.jit(lambda s: jref.ref_llg_rk4(
        s, jp, dt, n_steps, **kw_j))(jnp.asarray(st)))
    got = tref.ref_llg_rk4(torch.from_numpy(st), tp, dt, n_steps, **kw_t).numpy()
    return ref, got


def _lane_params(kind, cells, rng):
    _, tp = KINDS[kind]
    return np.stack([
        tp.alpha * rng.uniform(0.8, 1.2, cells),
        tp.b_aniso * rng.uniform(0.9, 1.1, cells),
        rng.uniform(0.85, 1.15, cells)]).astype(np.float32)


CASES = ["det", "thermal", "thermal-chunk64-budget", "variation-chunk64"]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", CASES)
def test_ref_llg_rk4_matches_reference(kind, case):
    """The reference's bound on its own test horizon (400 steps
    deterministic, 200 thermal), 512 lanes."""
    n_sub = KINDS[kind][0].n_sublattices
    st = _states(512, n_sub, 0.3, 1.2)
    rng = np.random.default_rng(3)
    if case == "det":
        ref, got = _run_both(kind, st, 0.1e-12, 400)
    else:
        n = 200
        budget = (np.where(np.arange(512) % 5 == 0, 70.0, float(n))
                  .astype(np.float32) if "budget" in case else None)
        lp = _lane_params(kind, 512, rng) if "variation" in case else None
        chunk = 64 if "chunk64" in case else 0
        ref, got = _run_both(kind, st, 0.1e-12, n, thermal=True, chunk=chunk,
                             budget=budget, lane_params=lp)
    np.testing.assert_allclose(got[:6], ref[:6], atol=ATOL)
    np.testing.assert_array_equal(got[6:], ref[6:])


REVERSAL = {"afmtj": (1500, 0.1e-12, 0.8, 2.0), "mtj": (3000, 0.2e-12, 2.0, 5.0)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", ["thermal-chunk64-budget", "variation"])
def test_ref_llg_rk4_across_reversal(kind, case):
    """A horizon that includes the reversal (see the module docstring for
    the AFMTJ bounds)."""
    n, dt, vlo, vhi = REVERSAL[kind]
    st = _states(512, KINDS[kind][0].n_sublattices, vlo, vhi, seed=4)
    budget = np.where(np.arange(512) % 7 == 0, n // 3, n).astype(np.float32)
    lp = (_lane_params(kind, 512, np.random.default_rng(5))
          if case == "variation" else None)
    ref, got = _run_both(kind, st, dt, n, thermal=True,
                         chunk=64 if "chunk64" in case else 0, budget=budget,
                         lane_params=lp)
    assert (ref[7] < n).sum() > 100          # the horizon covers reversals
    np.testing.assert_array_equal(got[6], ref[6])
    if kind == "mtj":
        np.testing.assert_array_equal(got[7], ref[7])
        np.testing.assert_allclose(got[:6], ref[:6], atol=ATOL)
        return
    d7 = np.abs(got[7] - ref[7])
    assert (d7 > 0).mean() <= AFMTJ_REVERSAL_ROW7_FRAC
    assert d7.max() <= AFMTJ_REVERSAL_ROW7_STEPS
    np.testing.assert_allclose(got[:6], ref[:6], atol=AFMTJ_REVERSAL_ATOL)


def test_chunked_exit_groups_keep_crossings():
    """1024 lanes = two exit groups of 512, the first of which finishes
    early (budget 300): stopping a finished group changes no first
    crossing, and the unfinished group's state equals a run without early
    exit."""
    st = torch.from_numpy(_states(1024, 2, 0.8, 2.0, seed=6))
    budget = torch.where(torch.arange(1024) < 512, 300.0, 1200.0)
    seeds = torch.from_numpy(np.asarray(jnoise.cell_seeds(3, 1024)).view(np.int32))
    kw = dict(thermal_sigma=thermal_sigma(AFMTJ_PARAMS, 0.1e-12), seeds=seeds,
              step_budget=budget)
    early = tref.ref_llg_rk4(st, AFMTJ_PARAMS, 0.1e-12, 1200, chunk=64, **kw)
    full = tref.ref_llg_rk4(st, AFMTJ_PARAMS, 0.1e-12, 1200, chunk=0, **kw)
    assert (full[7] < 1200).sum() > 100
    torch.testing.assert_close(early[7], full[7], rtol=0, atol=0)
    torch.testing.assert_close(early[:, 512:], full[:, 512:], rtol=0, atol=0)


def test_pack_unpack_states_match_reference():
    rng = np.random.default_rng(7)
    m0 = _unit(rng, (700, 2, 3))
    v = rng.uniform(0.5, 1.5, 700).astype(np.float32)
    ref = np.asarray(jops.pack_states(jnp.asarray(m0), jnp.asarray(v)))
    got = tops.pack_states(torch.from_numpy(m0), torch.from_numpy(v))
    assert got.shape == (8, 1024)
    np.testing.assert_array_equal(got.numpy(), ref)
    m_ref, c_ref = jops.unpack_states(jnp.asarray(ref), 700)
    m_got, c_got = tops.unpack_states(got, 700)
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))


def test_kernel_wrapper_runs_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and is not counted as a
    kernel launch."""
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    st = torch.from_numpy(_states(512, 2, 0.5, 1.0))
    before = llg_rk4_kernel.launches
    out = tops.llg_rk4(st, AFMTJ_PARAMS, 0.1e-12, 20)
    assert llg_rk4_kernel.launches == before
    np.testing.assert_array_equal(
        out.numpy(), tref.ref_llg_rk4(st, AFMTJ_PARAMS, 0.1e-12, 20).numpy())
    assert isinstance(AFMTJ_PARAMS, DeviceParams)


def test_kernel_wrapper_takes_int32_seed_bits_only():
    """Seeds travel as int32 bit patterns (``noise.cell_seeds``); the
    wrapper refuses widened int64 values on every device."""
    from repro_torch.kernels import noise as tnoise
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

    st = torch.from_numpy(_states(512, 2, 0.5, 1.0))
    seeds = tnoise.cell_seeds(5, 512, device="cpu")
    assert seeds.dtype == torch.int32
    kw = dict(thermal_sigma=thermal_sigma(J_AFMTJ, 0.1e-12))
    out = llg_rk4_kernel(st, AFMTJ_PARAMS, 0.1e-12, 10, seeds=seeds, **kw)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="int32"):
        llg_rk4_kernel(st, AFMTJ_PARAMS, 0.1e-12, 10,
                       seeds=tnoise.as_uint32(seeds), **kw)
