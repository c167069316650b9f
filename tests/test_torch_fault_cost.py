"""The port's hard-fault cost model against the JAX reference on the CPU:
the repair-capacity yield model, ``evaluate_system(faults=, repair=)`` and
``imc_cost_model(faults=, repair=)``, and the reference's own contracts
(``tests/test_faults.py``: yield bounds and ordering, the inert (1, 1, 1)
factors, cost and Fig. 4 charging, the serving SLO curve) run on the port.

Tolerances:

* ``_poisson_cdf``, ``repair_yield``, ``repair_cell_overhead`` and
  ``fault_cost_factors`` are pure float64 Python on both sides, operation
  for operation: equal (``==``).
* Fig. 4 and the cost model's prices, given the same device write
  characterization: ``CLOSED_FORM_RTOL`` = 1e-6, the closed-form bound of
  ``test_torch_system.py`` (both sides compute the circuit models in
  float32); ``array_yield`` is the float64 factor itself, so equal.
* Faults off (``faults=None``, or a spec with every rate 0) keeps the
  port's Fig. 4 bit for bit (``FIG4_TODAY`` of ``test_torch_read_path.py``).
"""
import dataclasses

import numpy as np
import pytest

from repro.circuit import subarray as jsub
from repro.imc import cost_model as jcost, evaluate as jeval
from repro.imc import faults as jfaults, mapping as jmapping
from repro_torch.circuit import subarray as tsub
from repro_torch.imc import cost_model as tcost, evaluate as teval
from repro_torch.imc import faults as tfaults, mapping as tmapping
from repro_torch.imc import write_path as twp
from test_torch_read_path import FIG4_TODAY

CLOSED_FORM_RTOL = 1e-6
RATES = (0.0, 1e-6, 1e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.5, 1.0)
POLICY_NAMES = (None, "none", "spare", "spare+ecc")


def _policies(name):
    """(port policy, reference policy) of ``name`` (None = no policy)."""
    if name is None:
        return None, None
    t = {p.name: p for p in tfaults.REPAIR_POLICIES}[name]
    j = {p.name: p for p in jfaults.REPAIR_POLICIES}[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _specs(rate, **kw):
    t = tfaults.FaultSpec.at_rate(rate, **kw)
    j = jfaults.FaultSpec.at_rate(rate, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


@pytest.fixture
def shared_write_characterization(monkeypatch):
    def char(kind, v_write, device=None):
        return jsub._characterize_write(kind, float(v_write))
    monkeypatch.setattr(tsub, "_characterize_write", char)
    twp.nominal_pulse.cache_clear()
    yield
    twp.nominal_pulse.cache_clear()


# --- the yield model: equal to the reference ----------------------------------

@pytest.mark.parametrize("k", [0, 1, 2, 8, 30])
def test_poisson_cdf_equals_reference(k):
    for lam in (0.0, -1.0, 1e-9, 0.3, 1.0, 7.5, 64.0, 512.0, 800.0):
        assert tmapping._poisson_cdf(k, lam) == jmapping._poisson_cdf(k, lam)


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("xbar", [512, 256, 64])
def test_repair_model_equals_reference(policy, xbar):
    pt, pj = _policies(policy)
    assert tmapping.repair_cell_overhead(pt, xbar) == \
        jmapping.repair_cell_overhead(pj, xbar)
    for rate in RATES:
        st, sj = _specs(rate, seed=3)
        assert tmapping.repair_yield(st, pt, xbar) == \
            jmapping.repair_yield(sj, pj, xbar), rate
        assert tmapping.fault_cost_factors(st, pt, xbar) == \
            jmapping.fault_cost_factors(sj, pj, xbar), rate
    # single-class specs: dead lines only, stuck cells only, wear
    for kw in (dict(dead_row_rate=1e-3), dict(dead_col_rate=2e-2),
               dict(stuck_on_rate=1e-3), dict(wear_per_cycle=1e-7,
                                              write_cycles=1e4),
               dict(drift_sigma=0.1)):
        st, sj = tfaults.FaultSpec(**kw), jfaults.FaultSpec(**kw)
        assert tmapping.fault_cost_factors(st, pt, xbar) == \
            jmapping.fault_cost_factors(sj, pj, xbar), kw
    assert tmapping.fault_cost_factors(None, pt, xbar) == (1.0, 1.0, 1.0)


# --- the reference's contracts (tests/test_faults.py) on the port ------------

def test_repair_yield_bounds_and_ordering():
    for rate in (1e-4, 1e-3, 1e-2):
        f = tfaults.FaultSpec.at_rate(rate)
        ys = [tmapping.repair_yield(f, pol) for pol in
              (None, tfaults.REPAIR_SPARE, tfaults.REPAIR_SPARE_ECC)]
        assert all(0.0 <= y <= 1.0 for y in ys)
        assert ys[1] >= ys[0] and ys[2] >= ys[0]
    for pol in (None, tfaults.REPAIR_SPARE):
        ys = [tmapping.repair_yield(tfaults.FaultSpec.at_rate(r), pol)
              for r in (1e-5, 1e-4, 1e-3, 1e-2)]
        assert all(a >= b for a, b in zip(ys, ys[1:])), (pol, ys)


def test_fault_cost_factors_inert_and_active():
    assert tmapping.fault_cost_factors(None) == (1.0, 1.0, 1.0)
    assert tmapping.fault_cost_factors(
        tfaults.FaultSpec.at_rate(0.0)) == (1.0, 1.0, 1.0)
    y, ovh, stretch = tmapping.fault_cost_factors(
        tfaults.FaultSpec.at_rate(1e-3), tfaults.REPAIR_SPARE)
    assert 0.0 < y <= 1.0 and ovh > 1.0 and stretch >= ovh


def test_cost_model_fault_charging(shared_write_characterization):
    nom = tcost.imc_cost_model("afmtj", device="cpu")
    assert dataclasses.asdict(nom) == dataclasses.asdict(
        tcost.imc_cost_model("afmtj", faults=None, device="cpu"))
    f = tfaults.FaultSpec.at_rate(1e-3)
    bare = tcost.imc_cost_model("afmtj", faults=f, device="cpu")
    rep = tcost.imc_cost_model("afmtj", faults=f,
                               repair=tfaults.REPAIR_SPARE, device="cpu")
    assert bare.t_mac > nom.t_mac
    assert nom.t_mac < rep.t_mac < bare.t_mac
    assert rep.array_yield > bare.array_yield
    assert rep.e_mac > nom.e_mac


def test_evaluate_system_fault_charging(shared_write_characterization):
    nom = teval.evaluate_system("afmtj", device="cpu")
    nom2 = teval.evaluate_system("afmtj", faults=None, device="cpu")
    for k in nom:
        assert dataclasses.asdict(nom[k]) == dataclasses.asdict(nom2[k])
        assert nom[k].array_yield == 1.0
    f = tfaults.FaultSpec.at_rate(1e-3)
    bare = teval.evaluate_system("afmtj", faults=f, device="cpu")
    rep = teval.evaluate_system("afmtj", faults=f,
                                repair=tfaults.REPAIR_SPARE, device="cpu")
    assert bare["mac"].t_imc > nom["mac"].t_imc
    assert rep["mac"].t_imc < bare["mac"].t_imc
    assert rep["mac"].array_yield > bare["mac"].array_yield


def test_fault_slo_curve_degrades_monotonically(shared_write_characterization):
    from repro_torch.launch.simulate import fault_slo_curve

    pts = fault_slo_curve(rates=(0.0, 3e-4, 1e-3),
                          policies=(None, tfaults.REPAIR_SPARE),
                          n_requests=400, device="cpu")
    none = [p for p in pts if p.repair == "none"]
    spare = [p for p in pts if p.repair == "spare"]
    assert none[0].slo_attainment == spare[0].slo_attainment
    assert all(a.slo_attainment >= b.slo_attainment
               for a, b in zip(none, none[1:]))
    assert spare[-1].slo_attainment >= none[-1].slo_attainment


# --- against the reference ----------------------------------------------------

@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_faults_off_keeps_fig4_bit_for_bit(kind, shared_write_characterization):
    """``faults=None`` and an all-zero spec (with or without a repair
    policy) leave every field where ``FIG4_TODAY`` has it."""
    nominal = teval.evaluate_system(kind, device="cpu")
    for faults, repair in ((None, None), (None, tfaults.REPAIR_SPARE),
                           (tfaults.FaultSpec.at_rate(0.0), None),
                           (tfaults.FaultSpec.at_rate(0.0),
                            tfaults.REPAIR_SPARE_ECC)):
        res = teval.evaluate_system(kind, faults=faults, repair=repair,
                                    device="cpu")
        for name, (t_imc, e_imc) in FIG4_TODAY[kind].items():
            assert (res[name].t_imc, res[name].e_imc) == (
                float.fromhex(t_imc), float.fromhex(e_imc)), name
            assert dataclasses.asdict(res[name]) == \
                dataclasses.asdict(nominal[name])
            assert res[name].array_yield == 1.0


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
@pytest.mark.parametrize("rate", [1e-4, 1e-3, 1e-2])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_evaluate_system_faults_match_reference(kind, rate, policy,
                                                shared_write_characterization):
    pt, pj = _policies(policy)
    st, sj = _specs(rate)
    got = teval.evaluate_system(kind, faults=st, repair=pt, device="cpu")
    ref = jeval.evaluate_system(kind, faults=sj, repair=pj)
    assert set(got) == set(ref)
    for name in ref:
        assert [f.name for f in dataclasses.fields(got[name])] == \
            [f.name for f in dataclasses.fields(ref[name])]
        assert got[name].array_yield == ref[name].array_yield
        for attr in ("t_cpu", "e_cpu", "t_imc", "e_imc", "speedup",
                     "energy_saving"):
            np.testing.assert_allclose(getattr(got[name], attr),
                                       getattr(ref[name], attr),
                                       rtol=CLOSED_FORM_RTOL, err_msg=attr)


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_cost_model_faults_match_reference(kind, policy,
                                           shared_write_characterization):
    pt, pj = _policies(policy)
    for rate in (0.0, 1e-3):
        st, sj = _specs(rate)
        got = tcost.imc_cost_model(kind, faults=st, repair=pt, device="cpu")
        ref = jcost.imc_cost_model(kind, faults=sj, repair=pj)
        for f in dataclasses.fields(ref):
            x, y = getattr(got, f.name), getattr(ref, f.name)
            if isinstance(y, str) or y in (0.0, 1.0) or not np.isfinite(y):
                assert x == y, f.name
            else:
                np.testing.assert_allclose(x, y, rtol=CLOSED_FORM_RTOL,
                                           err_msg=f.name)
