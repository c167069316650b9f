"""The port's device -> circuit -> Fig. 4 chain against the JAX reference
on the CPU (the measured write path is in ``test_torch_write_path.py``).

* ``simulate_write``: the Fig. 3 writes at 1 V, compared at a horizon just
  past the switch (3000 steps of 0.05 ps AFMTJ, 14000 of 0.1 ps MTJ; the
  full 16000/40000-step horizons take about a minute in eager PyTorch on
  one CPU core).  t_switch within one step (measured: equal); energy
  within rtol 1e-5 (measured 6e-8 AFMTJ, 4e-7 MTJ: the reference runs this
  scan with traced float32 parameters, the port with float32-rounded
  double constants); final state within 1e-4 (measured 1.2e-5).
* The closed-form circuit and system layers (bit line, sense amp,
  subarray, hierarchy, Fig. 4): given the same device write
  characterization, equal to rtol 1e-6 (both sides compute the circuit
  models in float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.circuit import subarray as jsub
from repro.core.device import simulate_write as jsimulate_write
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ, MTJ_PARAMS as J_MTJ
from repro.imc import evaluate as jeval, hierarchy as jhier
from repro_torch.circuit import subarray as tsub
from repro_torch.core.device import simulate_write as tsimulate_write
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.imc import evaluate as teval, hierarchy as thier
from repro_torch.imc import write_path as twp

WRITE = {"afmtj": (J_AFMTJ, AFMTJ_PARAMS, 3000, 0.05e-12),
         "mtj": (J_MTJ, MTJ_PARAMS, 14000, 0.1e-12)}
ENERGY_RTOL = 1e-5
CLOSED_FORM_RTOL = 1e-6


@pytest.mark.parametrize("kind", sorted(WRITE))
def test_simulate_write_fig3(kind):
    jp, tp, n, dt = WRITE[kind]
    ref = jsimulate_write(jp, 1.0, n_steps=n, dt=dt)
    got = tsimulate_write(tp, 1.0, n_steps=n, dt=dt, device="cpu")
    assert bool(ref.switched) and bool(got.switched)
    assert abs(float(got.t_switch) - float(ref.t_switch)) <= dt * 1.0001
    assert abs(float(got.write_latency) - float(ref.write_latency)) <= 1.03 * dt
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=ENERGY_RTOL)
    np.testing.assert_allclose(got.final_state.numpy(),
                               np.asarray(ref.final_state), atol=1e-4)


@pytest.fixture
def shared_write_characterization(monkeypatch):
    """Both sides' closed-form paths use the reference's device write
    characterization (its full-horizon scan is fast under jit)."""
    def char(kind, v_write, device=None):
        return jsub._characterize_write(kind, float(v_write))
    monkeypatch.setattr(tsub, "_characterize_write", char)
    twp.nominal_pulse.cache_clear()
    yield
    twp.nominal_pulse.cache_clear()


def _close(a, b, rtol=CLOSED_FORM_RTOL):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float) and x is not None:
            np.testing.assert_allclose(x, y, rtol=rtol, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_closed_form_chain_matches_reference(kind,
                                             shared_write_characterization):
    ref_sub = jsub.make_subarray(kind)
    got_sub = tsub.make_subarray(kind, device="cpu")
    _close(got_sub.timings, ref_sub.timings)
    got_h = thier.build_hierarchy(kind, device="cpu")
    ref_h = jhier.build_hierarchy(kind)
    for name in ("L1", "L2", "MM"):
        _close(got_h.levels[name].timings, ref_h.levels[name].timings)
    got = teval.evaluate_system(kind, device="cpu")
    ref = jeval.evaluate_system(kind)
    assert set(got) == set(ref)
    for name in ref:
        for attr in ("t_cpu", "e_cpu", "t_imc", "e_imc", "t_write_op",
                     "speedup", "energy_saving"):
            np.testing.assert_allclose(getattr(got[name], attr),
                                       getattr(ref[name], attr),
                                       rtol=CLOSED_FORM_RTOL, err_msg=attr)
    np.testing.assert_allclose(teval.summarize(got), jeval.summarize(ref),
                               rtol=CLOSED_FORM_RTOL)
    np.testing.assert_allclose(teval.summarize_geomean(got),
                               jeval.summarize_geomean(ref),
                               rtol=CLOSED_FORM_RTOL)


def test_subarray_logic_ops_functional(shared_write_characterization):
    sub = tsub.make_subarray("afmtj", rows=8, cols=8, device="cpu")
    a = torch.tensor([0, 0, 1, 1, 0, 1, 1, 0], dtype=torch.uint8)
    b = torch.tensor([0, 1, 0, 1, 1, 1, 0, 0], dtype=torch.uint8)
    c = torch.tensor([1, 1, 1, 0, 0, 1, 0, 0], dtype=torch.uint8)
    sub.write_row(0, a).write_row(1, b).write_row(2, c)
    assert torch.equal(sub.logic((0, 1), "and"), a & b)
    assert torch.equal(sub.logic((0, 1), "or"), a | b)
    assert torch.equal(sub.logic((0, 1), "xor"), a ^ b)
    assert torch.equal(sub.logic((0, 1, 2), "maj"),
                       ((a.int() + b.int() + c.int()) >= 2).to(torch.uint8))
