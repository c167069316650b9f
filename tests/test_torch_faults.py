"""The port's hard-fault planes and repair against the JAX reference.

The defect planes come from the counter-RNG (uint32 on masked int64 in the
port), so ``fault_code_plane``, ``column_ok_plane``, ``apply_repair`` and
``apply_cell_faults`` must be bit-equal to the reference's
(``tests/test_faults.py:113``).  ``drift_factors`` goes through Box-Muller,
whose log/cos come from different libraries: within 4 float32 ulps of 1.0
(ROADMAP C4).  Programming and the MVM with faults active are held to the
parity tolerances of ``tests/test_analog_pipeline.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.imc import analog_pipeline as jap
from repro.imc import faults as jf
from repro.imc import model_analog as jma
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import faults as tf
from repro_torch.imc import model_analog as tma
from repro_torch.kernels import ops
from repro_torch.models.model import params_from_reference
from repro_torch.kernels.fake_analog import (FAULT_DEAD, FAULT_NEG_OFF,
                                             FAULT_NEG_ON, FAULT_POS_OFF,
                                             FAULT_POS_ON, fail_bit)

CPU = "cpu"
POLICIES = {p.name: p for p in tf.REPAIR_POLICIES}
J_POLICIES = {p.name: p for p in jf.REPAIR_POLICIES}


def _np(t):
    return t.detach().cpu().numpy()


def _wx(k=200, n=150, m=7, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((k, n)) / k**0.5).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


PLANES = [(0, 0.05, 0.07, 0.05, 0.2), (7, 1e-2, 1e-2, 0.0, 0.1),
          (2**32 - 5, 0.0, 0.0, 0.0, 0.0), (123456, 0.3, 0.3, 0.3, 0.5)]


@pytest.mark.parametrize("seed,on,off,drow,dcol", PLANES)
def test_planes_bit_equal(seed, on, off, drow, dcol):
    j = np.asarray(jf.fault_code_plane(50, 37, seed=np.uint32(seed),
                                       stuck_on=on, stuck_off=off,
                                       dead_row=drow))
    t = _np(tf.fault_code_plane(50, 37, seed=seed, stuck_on=on,
                                stuck_off=off, dead_row=drow))
    assert t.dtype == np.float32 and np.array_equal(t, j)
    jo = np.asarray(jf.column_ok_plane(37, seed=np.uint32(seed),
                                       dead_col=dcol))
    to = _np(tf.column_ok_plane(37, seed=seed, dead_col=dcol))
    assert np.array_equal(to, jo)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_apply_repair_bit_equal(policy, seed):
    kw = dict(stuck_on=0.04, stuck_off=0.04, dead_row=0.05)
    jc, jo = jf.apply_repair(
        jf.fault_code_plane(64, 40, seed=np.uint32(seed), **kw),
        jf.column_ok_plane(40, seed=np.uint32(seed), dead_col=0.2),
        J_POLICIES[policy])
    tc, to = tf.apply_repair(
        tf.fault_code_plane(64, 40, seed=seed, **kw),
        tf.column_ok_plane(40, seed=seed, dead_col=0.2), POLICIES[policy])
    assert np.array_equal(_np(tc), np.asarray(jc))
    assert np.array_equal(_np(to), np.asarray(jo))


def test_apply_repair_hand_built():
    """Semantics on a hand-built map (ECC, pair masking, spare rows/cols)."""
    code = torch.zeros(6, 5)
    code[0, 0] = FAULT_POS_ON
    code[0, 1] = FAULT_NEG_OFF
    code[1, :] = FAULT_DEAD
    code[2, 3] = FAULT_NEG_ON
    col_ok = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    jc, jo = jf.apply_repair(jnp.asarray(_np(code)), jnp.asarray(_np(col_ok)),
                             jf.REPAIR_SPARE_ECC)
    tc, to = tf.apply_repair(code, col_ok, tf.REPAIR_SPARE_ECC)
    assert np.array_equal(_np(tc), np.asarray(jc))
    assert np.array_equal(_np(to), np.asarray(jo))
    assert tf.apply_repair(code, col_ok, None)[0] is code


def test_apply_cell_faults_and_fail_bit_equal():
    codes = torch.arange(128.0)
    for b in (1, 2, FAULT_POS_OFF, FAULT_NEG_OFF, FAULT_POS_ON, FAULT_NEG_ON,
              FAULT_DEAD):
        expect = (np.arange(128) & int(b)) > 0
        assert np.array_equal(_np(fail_bit(codes, b)), expect), b
    rng = np.random.default_rng(0)
    code = rng.integers(0, 128, (30, 20)).astype(np.float32)
    gp = rng.uniform(1e-4, 3e-4, (30, 20)).astype(np.float32)
    gn = rng.uniform(1e-4, 3e-4, (30, 20)).astype(np.float32)
    kw = dict(g_off=1.1e-4, g_on=1.1e-4 + 2.2e-4)
    jp, jn = jf.apply_cell_faults(jnp.asarray(code), jnp.asarray(gp),
                                  jnp.asarray(gn), **kw)
    tp, tn = tf.apply_cell_faults(torch.from_numpy(code), torch.from_numpy(gp),
                                  torch.from_numpy(gn), **kw)
    assert np.array_equal(_np(tp), np.asarray(jp))
    assert np.array_equal(_np(tn), np.asarray(jn))


def test_fault_spec_properties_match():
    for kw in (dict(wear_per_cycle=1e-6, write_cycles=1e5),
               dict(stuck_off_rate=0.01, wear_per_cycle=1e-6,
                    write_cycles=1e5), dict(), dict(drift_sigma=0.1)):
        j, t = jf.FaultSpec(**kw), tf.FaultSpec(**kw)
        for f in ("wear_rate", "stuck_off_effective", "cell_fault_rate",
                  "any_faults"):
            assert getattr(t, f) == getattr(j, f), (kw, f)
    assert dataclasses.asdict(tf.FaultSpec.at_rate(3e-3, seed=2)) == \
        dataclasses.asdict(jf.FaultSpec.at_rate(3e-3, seed=2))


@pytest.mark.parametrize("negative", [False, True])
def test_drift_factors_within_ulps(negative):
    j = np.asarray(jf.drift_factors(jf.FaultSpec(drift_sigma=0.1, seed=3),
                                    20, 30, negative=negative))
    t = _np(tf.drift_factors(tf.FaultSpec(drift_sigma=0.1, seed=3), 20, 30,
                             negative=negative))
    np.testing.assert_allclose(t, j, rtol=4 * 2**-23, atol=0)


def _fault_cfgs(rate=1e-2, repair=None, **kw):
    jr = None if repair is None else J_POLICIES[repair]
    tr = None if repair is None else POLICIES[repair]
    return (jap.AnalogConfig(adc_bits=6, faults=jf.FaultSpec.at_rate(rate, seed=2),
                             repair=jr, **kw),
            tap.AnalogConfig(adc_bits=6, faults=tf.FaultSpec.at_rate(rate, seed=2),
                             repair=tr, **kw))


@pytest.mark.parametrize("repair", [None, "spare", "spare+ecc"])
def test_program_and_fake_with_faults_match_reference(repair):
    w, x = _wx(k=130, n=100, m=5, seed=4)
    jcfg, tcfg = _fault_cfgs(3e-2, repair)
    aj = jap.program_weights(jnp.asarray(w), "afmtj", jcfg)
    at = tap.program_weights(w, "afmtj", tcfg, device=CPU)
    gj = np.asarray(aj.g_diff)
    np.testing.assert_allclose(_np(at.g_diff), gj, rtol=0,
                               atol=2e-6 * np.abs(gj).max())
    assert at.att_mean == pytest.approx(aj.att_mean, rel=1e-6)
    yj = np.asarray(jap.analog_matmul(aj, jnp.asarray(x)))
    yt = _np(tap.analog_matmul(at, torch.from_numpy(x)))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())
    _, i_max, _ = jap.kernel_operands(aj, jnp.asarray(x))
    fj = np.asarray(jma.fake_analog_matmul(jnp.asarray(w), jnp.asarray(x),
                                           cfg=jcfg, i_max=i_max,
                                           interpret=True))
    ft = _np(tma.fake_analog_matmul(w, x, cfg=tcfg, i_max=i_max, device=CPU))
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-5 * np.abs(fj).max())
    np.testing.assert_allclose(ft, yt, rtol=1e-5, atol=1e-5 * np.abs(yt).max())


@pytest.mark.parametrize("repair", [None, "spare"])
def test_port_fault_raw_currents_bit_equal(repair):
    """Within the port: stuck-at + dead-line planes active, no IR drop,
    shared full scale: raw currents bit-equal between the two paths."""
    w, x = _wx()
    _, cfg = _fault_cfgs(repair=repair, ir_drop=False)
    arr = tap.program_weights(w, "afmtj", cfg, device=CPU)
    v, i_max, _ = tap.kernel_operands(arr, x)
    i_dev = ops.bitline_mac(v, arr.g_diff, 6, i_max=i_max)
    i_fake = tma.fake_analog_matmul(w, x, cfg=cfg, i_max=i_max, decode=False,
                                    device=CPU)
    assert torch.equal(i_fake, i_dev)


def test_zero_rate_spec_bit_identical():
    w, x = _wx(k=130, n=100, m=5)
    base = tap.AnalogConfig(adc_bits=6)
    zero = dataclasses.replace(base, faults=tf.FaultSpec.at_rate(0.0),
                               repair=tf.REPAIR_SPARE)
    assert torch.equal(tma.fake_analog_matmul(w, x, cfg=base, device=CPU),
                       tma.fake_analog_matmul(w, x, cfg=zero, device=CPU))
    a0 = tap.program_weights(w, "afmtj", base, device=CPU)
    az = tap.program_weights(w, "afmtj", zero, device=CPU)
    assert torch.equal(a0.g_diff, az.g_diff) and a0.att_mean == az.att_mean


def test_drift_is_device_path_only():
    w, x = _wx(k=64, n=32, m=2)
    cfg = tap.AnalogConfig(adc_bits=6, faults=tf.FaultSpec(drift_sigma=0.1))
    with pytest.raises(NotImplementedError):
        tma.fake_analog_matmul(w, x, cfg=cfg, device=CPU)
    jcfg = jap.AnalogConfig(adc_bits=6, faults=jf.FaultSpec(drift_sigma=0.1))
    gj = np.asarray(jap.program_weights(jnp.asarray(w), "afmtj", jcfg).g_diff)
    gt = _np(tap.program_weights(w, "afmtj", cfg, device=CPU).g_diff)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=2e-6 * np.abs(gj).max())


def test_repair_reduces_error_on_same_defect_map():
    w, x = _wx(k=130, n=100, m=5, seed=6)
    ideal = x @ w
    y_none = _np(tma.fake_analog_matmul(w, x, cfg=_fault_cfgs(3e-2)[1],
                                        device=CPU))
    y_rep = _np(tma.fake_analog_matmul(
        w, x, cfg=_fault_cfgs(3e-2, "spare")[1], device=CPU))
    assert np.mean((y_rep - ideal) ** 2) < np.mean((y_none - ideal) ** 2)


def test_degradation_knee_reduction():
    def rep(rate, repair, match):
        return tma.ModelAccuracyReport(
            arch="a", kind="afmtj", mode="fake", adc_bits=6, tmr=0.0,
            corner="tt", write_ber=0.0, kl=0.0, token_match=match,
            ppl_analog=1.0, ppl_ref=1.0, batch=1, seq_len=1,
            fault_rate=rate, repair=repair)

    reports = [rep(0.0, "none", 0.95), rep(1e-3, "none", 0.85),
               rep(1e-2, "none", 0.40),
               rep(0.0, "spare", 0.95), rep(1e-3, "spare", 0.94),
               rep(1e-2, "spare", 0.90)]
    assert tma.degradation_knee(reports, min_token_match=0.8) == \
        {"none": 1e-3, "spare": 1e-2}


def test_degradation_curves_match_reference(monkeypatch):
    """qwen2 smoke (batch 2 x seq 64) with the reference's parameters:
    model accuracy with spare-line repair at fault rates 0 and 1e-2, KL
    within 1e-4 of the reference's and the same token match."""
    kw = dict(rates=(0.0, 1e-2), adc_bits=6, batch=2, seq_len=64)
    params = jma._setup("qwen2-0.5b", True, 2, 64, 0)[1]
    tree = jax.tree_util.tree_map(np.asarray, params)
    monkeypatch.setattr(tma, "init_model_params",
                        lambda cfg, seed, device: params_from_reference(
                            tree, device))
    rj = jma.model_degradation_curves("qwen2-0.5b",
                                      policies=(jf.REPAIR_SPARE,), **kw)
    rt = tma.model_degradation_curves("qwen2-0.5b",
                                      policies=(tf.REPAIR_SPARE,),
                                      device=CPU, **kw)
    assert len(rt) == len(rj) == 2
    for a, b in zip(rj, rt):
        assert (a.repair, a.fault_rate) == (b.repair, b.fault_rate)
        assert b.kl == pytest.approx(a.kl, abs=1e-4)
        assert b.token_match == a.token_match
