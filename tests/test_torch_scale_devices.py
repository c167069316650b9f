"""Campaign scale-out of the port on the CPU, second part: donated
launches, device plans and the claim protocol (``tests/test_scale.py:196-
353``), each held against the port's own undonated, one-device launch bit
for bit, and the reference's where the port's device plan has one
(``plan_cell_tiles``; 200 steps of ``run_ensemble``, C3: row 7 equal).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import run_ensemble as jrun_ensemble
from repro.core import llg as jllg
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ
from repro.launch.sharding import plan_cell_tiles as jplan_cell_tiles
from repro_torch.campaign import cache, engine
from repro_torch.core.params import AFMTJ_PARAMS
from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
from repro_torch.launch.sharding import plan_cell_tiles
from test_torch_scale import CPU, _grid, _run, dense_result  # noqa: F401


# ------------------------------------------------------------- donation
def test_donated_campaign_bit_identical(dense_result):
    """One launch over the whole block: the kernel writes into the packed
    state itself (split and multi-device donated launches are below)."""
    res = _run(donate=True)
    np.testing.assert_array_equal(res.crossing_time,
                                  dense_result.crossing_time)


@pytest.mark.parametrize("chunk", [0, 64])
def test_donated_kernel_call_aliases_the_state(chunk):
    from repro_torch.campaign.grid import pack_campaign

    grid = _grid(temperatures=(300.0,), n_samples=8)
    state, seeds, sigma, budget, _ = pack_campaign(grid, AFMTJ_PARAMS, CPU)
    n = 320
    kw = dict(thermal_sigma=sigma, seeds=seeds,
              step_budget=torch.clamp(budget, max=300.0), chunk=chunk)
    plain = llg_rk4_kernel(state, AFMTJ_PARAMS, grid.dt, n, **kw)
    block = state.clone()
    ptr = block.data_ptr()
    out = llg_rk4_kernel(block, AFMTJ_PARAMS, grid.dt, n, **kw, out=block)
    assert out.data_ptr() == ptr and out is block
    assert torch.equal(out, plain)
    other = torch.empty_like(state)
    assert llg_rk4_kernel(state, AFMTJ_PARAMS, grid.dt, n, **kw,
                          out=other) is other
    assert torch.equal(other, plain)


def test_kernel_rejects_a_bad_out():
    state = torch.zeros(8, 1024)
    args = (AFMTJ_PARAMS, 1e-13, 4)
    with pytest.raises(ValueError, match="overlaps"):
        llg_rk4_kernel(state[:, :512], *args,
                       out=torch.as_strided(state, (8, 512), (512, 1), 256))
    with pytest.raises(ValueError, match="contiguous"):
        llg_rk4_kernel(state, *args, out=torch.zeros(8, 512))
    with pytest.raises(ValueError, match="contiguous"):
        llg_rk4_kernel(state, *args, out=torch.zeros(8, 1024,
                                                     dtype=torch.float64))


def test_donation_retry_repacks_consumed_inputs(monkeypatch):
    """A retry after a donated launch consumed the block packs it again
    instead of integrating from the consumed block."""
    grid = _grid(temperatures=(300.0,), n_samples=8,
                 pulse_widths=(20e-12, 30e-12))
    real = engine.llg_rk4_kernel
    real_pack = engine.pack_campaign
    calls = {"n": 0, "packs": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        out = real(*a, **kw)
        if calls["n"] == 1:
            assert kw["out"] is a[0]            # the donated block
            raise RuntimeError("transient loss after donation")
        return out

    def pack(*a, **kw):
        calls["packs"] += 1
        return real_pack(*a, **kw)

    monkeypatch.setattr(engine, "llg_rk4_kernel", flaky)
    monkeypatch.setattr(engine, "pack_campaign", pack)
    res = _run(grid, donate=True, max_retries=1, retry_backoff_s=0.0)
    assert calls["n"] == 2 and calls["packs"] == 2
    monkeypatch.setattr(engine, "llg_rk4_kernel", real)
    clean = _run(grid)
    np.testing.assert_array_equal(res.crossing_time, clean.crossing_time)


def test_write_verify_donate_bit_identical():
    import dataclasses as _dc

    from repro_torch.imc.write_path import WritePolicy, write_verify

    pol = WritePolicy(v_write=1.0, pulse=110e-12, max_attempts=2, seed=5,
                      use_cache=False, donate=True)
    res = write_verify("afmtj", 96, pol, device=CPU)
    ref = write_verify("afmtj", 96, _dc.replace(pol, donate=False),
                       device=CPU)
    assert res.rounds == ref.rounds > 1
    for f in ("attempts", "success", "crossing_time", "energy"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))


def test_write_verify_variation_donate_bit_identical():
    import dataclasses as _dc

    from repro_torch.core.params import CORNER_SS, VariationSpec
    from repro_torch.imc.write_path import WritePolicy, write_verify

    pol = WritePolicy(v_write=1.0, pulse=110e-12, max_attempts=2, seed=3,
                      use_cache=False, donate=True,
                      variation=VariationSpec(corners=(CORNER_SS,)))
    res = write_verify("afmtj", 64, pol, device=CPU)
    ref = write_verify("afmtj", 64, _dc.replace(pol, donate=False),
                       device=CPU)
    for f in ("attempts", "success", "crossing_time", "energy"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))


# ------------------------------------------------- device plans (pad)
def test_plan_cell_tiles_units():
    cases = [(4, 1, (4, 4)), (4, 3, (2, 6)), (4, 5, (1, 5)), (4, 6, (1, 6)),
             (8, 8, (1, 8)), (1, 4, (1, 4)), (1536, 7, (220, 1540))]
    for tiles, n, want in cases:
        assert plan_cell_tiles(tiles, n) == want == jplan_cell_tiles(tiles, n)
    with pytest.raises(AssertionError):
        plan_cell_tiles(0, 4)


def test_device_list_resolution():
    cpu = torch.device("cpu")
    assert engine._device_list(None, cpu) == [cpu]
    assert engine._device_list(4, cpu) == [cpu]        # one CPU device
    assert engine._device_list(0, cpu) == [cpu]
    assert engine._device_list(["cpu"] * 3, cpu) == [cpu] * 3
    with pytest.raises(ValueError):
        engine._device_list([], cpu)


@pytest.fixture(scope="module")
def ensemble_inputs():
    return np.array(jax.vmap(lambda t: jllg.initial_state(J_AFMTJ, t, 0.2))(
        jnp.linspace(0.05, 0.15, 2048)))


@pytest.fixture(scope="module")
def one_device_ensemble(ensemble_inputs):
    return engine.run_ensemble(AFMTJ_PARAMS, torch.from_numpy(
        ensemble_inputs), torch.full((2048,), 1.0), 0.1e-12, 200, seed=3,
        device=CPU)


@pytest.mark.parametrize("n_dev", [3, 5, 6])
def test_uneven_device_counts_pad_not_demote(n_dev, ensemble_inputs,
                                             one_device_ensemble):
    """A 2048-lane span on 3, 5 or 6 devices keeps every device (padding
    the lanes) and equals the one-device run bit for bit, and (200 steps,
    C3) the reference's crossing steps."""
    devs = [CPU] * n_dev
    got_n, plan_cols = engine._device_plan(2048, devs, CPU)
    assert got_n == n_dev
    assert plan_cols % (512 * n_dev) == 0 and plan_cols >= 2048
    calls = []
    real = engine.llg_rk4_kernel

    def kernel(state, *a, **kw):
        calls.append(state.shape[1])
        return real(state, *a, **kw)

    import unittest.mock as mock
    with mock.patch.object(engine, "llg_rk4_kernel", kernel):
        res = engine.run_ensemble(
            AFMTJ_PARAMS, torch.from_numpy(ensemble_inputs),
            torch.full((2048,), 1.0), 0.1e-12, 200, seed=3, devices=devs,
            device=CPU)
    assert calls == [plan_cols // n_dev] * n_dev
    np.testing.assert_array_equal(res.crossing_steps,
                                  one_device_ensemble.crossing_steps)
    np.testing.assert_array_equal(res.final_state,
                                  one_device_ensemble.final_state)
    if n_dev == 3:
        ref = jrun_ensemble(J_AFMTJ, jnp.asarray(ensemble_inputs),
                            jnp.full((2048,), 1.0), 0.1e-12, 200, seed=3,
                            backend="ref")
        np.testing.assert_array_equal(res.crossing_steps,
                                      ref.crossing_steps)


def test_campaign_on_three_devices_bit_identical(dense_result):
    res = _run(devices=[CPU] * 3, donate=True)
    np.testing.assert_array_equal(res.crossing_time,
                                  dense_result.crossing_time)


# ------------------------------------------------------ lockless claims
def test_claim_protocol(tmp_path):
    d = str(tmp_path)
    assert cache.try_claim("k1", d, owner="a")
    assert not cache.try_claim("k1", d, owner="b")   # exclusive
    age = cache.claim_age_s("k1", d)
    assert age is not None and age >= 0.0
    assert cache.claim_age_s("nope", d) is None
    assert not cache.steal_claim("k1", ttl_s=60.0, cache_dir=d, owner="b")
    old = time.time() - 120.0
    os.utime(cache.claim_path("k1", d), (old, old))
    assert cache.steal_claim("k1", ttl_s=60.0, cache_dir=d, owner="b")
    assert '"owner": "b"' in cache.claim_path("k1", d).read_text()
    assert cache.release_claim("k1", d)
    assert not cache.release_claim("k1", d)
    cache.try_claim("k2", d)
    assert cache.gc_stale_claims(d, max_age_s=3600.0) == 0
    assert cache.gc_stale_claims(d, max_age_s=0.0) == 1
    assert cache.claim_age_s("k2", d) is None
    assert cache.claim_path("k1", d) == tmp_path / "k1.claim"


def test_gc_stale_tmp_and_drop_arrays(tmp_path):
    d = str(tmp_path)
    stale, fresh = tmp_path / "a.tmp", tmp_path / "b.tmp"
    stale.write_bytes(b"x")
    fresh.write_bytes(b"x")
    old = time.time() - 2 * 86400.0
    os.utime(stale, (old, old))
    cache.store_arrays("k", {"x": np.arange(3)}, {"h": 1}, d)  # sweeps
    assert not stale.exists() and fresh.exists()
    assert cache.gc_stale_tmp(d, max_age_s=0.0) == 1
    assert cache.gc_stale_tmp(str(tmp_path / "absent")) == 0
    np.testing.assert_array_equal(cache.load_arrays("k", d)["x"],
                                  np.arange(3))
    assert cache.drop_arrays("k", d) and cache.load_arrays("k", d) is None
    assert not cache.drop_arrays("k", d)
