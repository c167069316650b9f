"""Campaign scale-out of the port on the CPU: the streaming reduction, split
launches, crash resume and retries, held against the reference
(``tests/test_scale.py``, ``tests/test_fused_engine.py:113``) on shared
inputs, and against the port's own single launch bit for bit (donation,
device plans and claims: ``test_torch_scale_devices.py``).

Bounds: the reduction's helpers and ``_reduce_rows`` equal the reference's
outputs exactly on the same crossing rows.  Whole campaigns against the
reference keep ``test_torch_campaign.py``'s C3 bound (crossing rows at most
2 steps apart on at most 1% of lanes; WER moves only by the lanes that
moved).  Everything the port computes two ways (dense and streamed, split
and single) is equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign.engine as jengine
from repro.campaign import run_campaign as jrun_campaign
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ
from repro_torch.campaign import CampaignGrid
from repro_torch.campaign import engine
from repro_torch.campaign.grid import bucket_cells
from repro_torch.core.params import AFMTJ_PARAMS
from test_torch_campaign import (ROW7_FRAC, ROW7_STEPS, _ref_grid,  # noqa: F401
                                 shared_tilts)

CPU = "cpu"


def _grid(**kw):
    """``tests/test_scale.py``'s grid with shorter pulses (1,001 steps, a
    third of its cost on the CPU) and as many samples as fill a slice's
    512-lane bucket half: every slice still has switched and unswitched
    lanes."""
    base = dict(voltages=(0.6, 1.2), pulse_widths=(60e-12, 100e-12),
                temperatures=(300.0, 350.0, 400.0), n_samples=128,
                dt=0.1e-12, seed=0)
    base.update(kw)
    return CampaignGrid(**base)


def _run(grid=None, **kw):
    kw.setdefault("use_cache", False)
    return engine.run_campaign(AFMTJ_PARAMS, grid or _grid(), device=CPU,
                               **kw)


@pytest.fixture(scope="module")
def dense_result():
    return _run()


# ------------------------------------------- the reduction's helpers
@pytest.mark.parametrize("dt,pulses,n_steps", [
    (0.1e-12, (100e-12, 123.4e-12, 250e-12, 399.9e-12), 4001),
    (0.1e-12, (120e-12, 250e-12), 2501),
    (0.2e-12, (200e-12, 300e-12, 450e-12), 2251),
    (0.05e-12, (10e-12, 33.3e-12, 165e-12), 3301),
])
def test_wer_threshold_steps_match_reference(dt, pulses, n_steps):
    ks = engine._wer_threshold_steps(pulses, dt, n_steps)
    np.testing.assert_array_equal(
        ks, jengine._wer_threshold_steps(pulses, dt, n_steps))
    for k, pl in zip(ks, pulses):
        assert np.float64(k) * dt > pl
        assert np.float64(k - 1) * dt <= pl


@pytest.mark.parametrize("n_steps,n_bins", [(2501, 4096), (2501, 512),
                                            (2501, 97), (50, 50), (4001, 128)])
def test_hist_step_values_match_reference(n_steps, n_bins):
    np.testing.assert_array_equal(engine._hist_step_values(n_steps, n_bins),
                                  jengine._hist_step_values(n_steps, n_bins))


@pytest.mark.parametrize("n_bins", [50, 13])
def test_percentiles_from_hist_match_reference(n_bins):
    rng = np.random.default_rng(n_bins)
    n_steps = 50
    hist = rng.integers(0, 5, size=(2, 3, n_bins))
    hist[1, 2] = 0                                   # an all-unswitched cell
    values = engine._hist_step_values(n_steps, n_bins) * 1e-12
    qs = (5.0, 50.0, 95.0, 99.0)
    got = engine._percentiles_from_hist(hist, values, qs)
    np.testing.assert_array_equal(
        got, jengine._percentiles_from_hist(hist, values, qs))
    assert np.isnan(got[1, 2]).all() and not np.isnan(got[0]).any()


def test_percentiles_from_hist_matches_numpy():
    rng = np.random.default_rng(0)
    n_steps = 50
    steps = rng.integers(0, n_steps, size=400)
    hist = np.bincount(steps, minlength=n_steps)[None, :]
    values = engine._hist_step_values(n_steps, n_steps) * 1e-12
    qs = (5.0, 50.0, 95.0)
    np.testing.assert_array_equal(
        engine._percentiles_from_hist(hist, values, qs)[0],
        np.percentile(steps.astype(np.float64) * 1e-12, qs))


def _crossing_row(n_slices, slice_cells, n_v, n_s, n_steps, n_kernel, seed):
    """A float32 row 7 as a launch leaves it: crossing steps 1..n_steps on
    real lanes (every step value at least once), the rounded horizon's
    sentinel ``n_kernel`` on never-crossed lanes and padding."""
    rng = np.random.default_rng(seed)
    row = np.full(n_slices * slice_cells + 512, float(n_kernel), np.float32)
    real = n_v * n_s
    steps = np.concatenate([np.arange(1, n_steps + 1),
                            rng.integers(1, n_steps + 1,
                                         n_slices * real - n_steps)])
    steps = rng.permutation(steps).astype(np.float32)
    steps[rng.random(steps.size) < 0.1] = n_kernel     # never crossed
    for si in range(n_slices):
        row[si * slice_cells: si * slice_cells + real] = \
            steps[si * real: (si + 1) * real]
    return row


@pytest.mark.parametrize("n_bins", [4096, 2501, 512, 97, 1])
def test_reduce_rows_matches_reference(n_bins):
    """The port's on-device reduction against the reference's jitted
    ``_reduce_rows`` on one crossing row: counts and histogram equal (at
    ``n_bins < n_steps`` both bin in float32)."""
    n_slices, n_v, n_s, n_steps, n_kernel = 3, 2, 2000, 2501, 4096
    slice_cells = bucket_cells(n_v * n_s)
    row = _crossing_row(n_slices, slice_cells, n_v, n_s, n_steps, n_kernel,
                        seed=n_bins)
    kmin = engine._wer_threshold_steps((120e-12, 250e-12), 0.1e-12, n_steps)
    kw = dict(n_slices=n_slices, slice_cells=slice_cells, n_v=n_v, n_s=n_s,
              n_steps=n_steps, n_bins=n_bins)
    wer, hist = engine._reduce_rows(torch.from_numpy(row),
                                    torch.from_numpy(kmin), **kw)
    out = np.zeros((8, row.size), np.float32)
    out[7] = row
    jwer, jhist = jengine._reduce_rows(jnp.asarray(out), jnp.asarray(kmin),
                                       **kw)
    assert wer.dtype == hist.dtype == engine._count_dtype(n_s)
    np.testing.assert_array_equal(wer.numpy().astype(np.int64),
                                  np.asarray(jwer))
    np.testing.assert_array_equal(hist.numpy().astype(np.int64),
                                  np.asarray(jhist))
    assert int(hist.sum()) == int((row[:n_slices * slice_cells] < n_steps)
                                  .sum())


@pytest.mark.parametrize("n_s,dtype", [(1, torch.uint8), (255, torch.uint8),
                                       (256, torch.int16),
                                       (32767, torch.int16),
                                       (32768, torch.int32),
                                       (100_000, torch.int32)])
def test_count_dtype_holds_every_count(n_s, dtype):
    assert engine._count_dtype(n_s) == dtype
    assert torch.iinfo(dtype).max >= n_s


def test_streamed_campaign_against_reference_on_shared_tilts(shared_tilts):
    """Port and reference streamed campaigns on shared tilts (C3 bound).
    With one bin per step a lane whose crossing step moved changes at most
    two bins by one, so the histograms differ by at most twice the moved
    lanes (<= 1% of them), and each WER count by at most the moved lanes;
    the percentiles by at most 2 steps."""
    grid = _grid(n_samples=64)
    got = _run(grid, reduce="stream", n_bins=4096)
    ref = jrun_campaign(J_AFMTJ, _ref_grid(grid), backend="ref",
                        use_cache=False, reduce="stream", n_bins=4096)
    assert got.reduced and ref.reduced
    assert got.wer_counts.shape == ref.wer_counts.shape == (3, 2, 2)
    np.testing.assert_array_equal(got.hist_values, ref.hist_values)
    lanes = grid.n_samples * len(grid.voltages) * len(grid.temperatures)
    moved_max = int(ROW7_FRAC * lanes)
    dh = np.abs(got.latency_hist.astype(np.int64) - ref.latency_hist).sum()
    assert dh <= 2 * moved_max
    assert (np.abs(got.wer_counts - ref.wer_counts) <= moved_max).all()
    np.testing.assert_allclose(got.latency_percentiles(),
                               ref.latency_percentiles(), rtol=0,
                               atol=ROW7_STEPS * grid.dt)


# ------------------------------------------------- streaming (port)
def test_streaming_wer_bit_identical(dense_result):
    res = _run(reduce="stream")
    assert res.reduced and res.crossing_time is None
    np.testing.assert_array_equal(res.wer_surface(),
                                  dense_result.wer_surface())
    assert res.n_samples_total == dense_result.n_samples_total
    assert res.wer_counts.shape == (3, 2, 2)
    assert 0 < res.host_bytes < dense_result.host_bytes
    # dense mode copies row 7 of each launch and nothing else
    assert dense_result.host_bytes == 4 * 3 * bucket_cells(_grid().cells)


def test_streaming_percentiles_exact_with_per_step_bins(dense_result):
    grid = _grid()
    res = _run(reduce="stream", n_bins=4096)
    assert 4096 >= grid.n_steps and res.sketch_tolerance == 0.0
    qs = (10.0, 50.0, 90.0, 99.0)
    np.testing.assert_array_equal(res.latency_percentiles(qs),
                                  dense_result.latency_percentiles(qs))


def test_streaming_sketch_within_documented_tolerance(dense_result):
    grid = _grid()
    res = _run(reduce="stream", n_bins=128)
    tol = res.sketch_tolerance
    assert tol == 2.0 * grid.n_steps * grid.dt / 128
    lp_d = dense_result.latency_percentiles((50.0, 99.0))
    lp_s = res.latency_percentiles((50.0, 99.0))
    assert np.isnan(lp_d).sum() == np.isnan(lp_s).sum()
    assert np.nanmax(np.abs(lp_d - lp_s)) <= tol
    np.testing.assert_array_equal(res.wer_surface(),
                                  dense_result.wer_surface())
    assert res.host_bytes * 4 <= dense_result.host_bytes


def test_streaming_cache_separate_from_dense(tmp_path):
    grid = _grid(seed=11)
    kw = dict(use_cache=True, cache_dir=str(tmp_path))
    d1 = _run(grid, **kw)
    s1 = _run(grid, reduce="stream", **kw)
    assert not s1.from_cache
    s2 = _run(grid, reduce="stream", **kw)
    assert s2.from_cache and s2.reduced and s2.host_bytes == 0
    np.testing.assert_array_equal(s1.wer_counts, s2.wer_counts)
    np.testing.assert_array_equal(s1.latency_hist, s2.latency_hist)
    d2 = _run(grid, **kw)
    assert d2.from_cache
    np.testing.assert_array_equal(d1.crossing_time, d2.crossing_time)


def test_streaming_variation_grid():
    from repro_torch.core.params import CORNER_SS, CORNER_TT, VariationSpec

    spec = VariationSpec(corners=(CORNER_TT, CORNER_SS), seed=7)
    grid = _grid(variation=spec, temperatures=(300.0,))
    dense = _run(grid)
    res = _run(grid, reduce="stream", n_bins=4096)
    assert res.wer_counts.shape == (2, 1, 2, 2)
    np.testing.assert_array_equal(res.wer_surface(), dense.wer_surface())
    np.testing.assert_array_equal(res.latency_percentiles((50.0,)),
                                  dense.latency_percentiles((50.0,)))


def test_streaming_multilaunch_checkpoint_resume(tmp_path, dense_result):
    grid = _grid()
    per = bucket_cells(grid.cells)

    class Abort(Exception):
        pass

    def die_after_two(i, n):
        assert n == 3
        if i == 1:
            raise Abort

    kw = dict(use_cache=True, cache_dir=str(tmp_path),
              max_cells_per_launch=per, reduce="stream")
    with pytest.raises(Abort):
        _run(grid, on_slice_complete=die_after_two, **kw)
    res = _run(grid, **kw)
    assert res.n_resumed == 2 and not res.from_cache and res.n_computed == 1
    np.testing.assert_array_equal(res.wer_surface(),
                                  dense_result.wer_surface())
    assert not list(tmp_path.glob("*.claim"))
    assert len(list(tmp_path.glob("*.npz"))) == 1   # slices retired


# ------------------------------------------- split launches and resume
def test_split_launch_matches_single_launch(dense_result):
    """``max_cells_per_launch`` of one slice: 3 launches, all enqueued
    before the first copy, equal to the single launch bit for bit."""
    split = _run(max_cells_per_launch=bucket_cells(_grid().cells))
    assert split.n_launches == split.n_computed == 3
    assert dense_result.n_launches == 1
    np.testing.assert_array_equal(split.crossing_time,
                                  dense_result.crossing_time)


def test_split_launches_enqueue_before_the_first_copy(monkeypatch):
    """Every launch is dispatched before any payload is fetched."""
    events = []
    real = engine.llg_rk4_kernel

    def kernel(*a, **kw):
        events.append("launch")
        return real(*a, **kw)

    real_np = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        events.append("copy")
        return real_np(self, *a, **kw)

    monkeypatch.setattr(engine, "llg_rk4_kernel", kernel)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    grid = _grid(n_samples=8, temperatures=(300.0, 350.0),
                 pulse_widths=(20e-12, 30e-12))
    _run(grid, max_cells_per_launch=bucket_cells(grid.cells))
    assert events == ["launch", "launch", "copy", "copy"]


def test_kill_and_resume_bit_identical(tmp_path, dense_result):
    grid = _grid()
    per = bucket_cells(grid.cells)

    class Abort(Exception):
        pass

    def die(i, n):
        if i == 0:
            raise Abort

    kw = dict(use_cache=True, cache_dir=str(tmp_path),
              max_cells_per_launch=per)
    with pytest.raises(Abort):
        _run(grid, on_slice_complete=die, **kw)
    assert len(list(tmp_path.glob("*.npz"))) == 1     # launch 0's slice
    res = _run(grid, **kw)
    assert res.n_resumed == 1 and res.n_computed == 2
    np.testing.assert_array_equal(res.crossing_time,
                                  dense_result.crossing_time)
    # the whole entry is stored and the slice checkpoints are retired
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = _run(grid, **kw)
    assert again.from_cache and again.n_launches == 0


def test_slice_key_matches_reference_payload():
    """The slice key is the same content hash of the same fields as the
    reference's (only the whole-campaign key differs: the port's carries
    its tag)."""
    for kind in ("slice-row7", "slice-reduced-512"):
        assert (engine._slice_key("k", 0, 2, 64, "pow2", kind)
                == jengine._slice_key("k", 0, 2, 64, "pow2", kind))
    assert engine._launch_spans(7, 512, 1024) == \
        jengine._launch_spans(7, 512, 1024)
    assert engine._launch_spans(3, 512, None) == [(0, 3)]


def test_retry_ladder_recovers_a_failed_launch(monkeypatch, dense_result):
    real = engine.llg_rk4_kernel
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient launch failure")
        return real(*a, **kw)

    monkeypatch.setattr(engine, "llg_rk4_kernel", flaky)
    res = _run(max_retries=1, retry_backoff_s=0.0)
    assert calls["n"] == 2 and res.n_computed == 1
    np.testing.assert_array_equal(res.crossing_time,
                                  dense_result.crossing_time)


def test_retry_ladder_gives_up(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("permanent launch failure")

    monkeypatch.setattr(engine, "llg_rk4_kernel", broken)
    with pytest.raises(RuntimeError, match="permanent"):
        _run(_grid(n_samples=4, temperatures=(300.0,)), max_retries=2,
             retry_backoff_s=0.0)


def test_every_public_name_and_argument_has_a_counterpart():
    """Every top-level function and class of the reference's campaign
    cache and engine, ``launch/mesh.py``'s campaign half,
    ``plan_cell_tiles`` and ``runtime/elastic.py`` has a counterpart in
    the port, and every argument of ``run_campaign`` / ``run_ensemble``
    but ``backend`` (which the port's ``device`` replaces)."""
    import ast
    import inspect
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"

    def names(rel, pick=None):
        tree = ast.parse((root / rel).read_text())
        out = {n.name for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))
               and not n.name.startswith("_")}
        return out if pick is None else out & set(pick)

    pairs = [("campaign/cache.py", None), ("campaign/engine.py", None),
             ("runtime/elastic.py", None),
             ("launch/mesh.py", ("CampaignMesh", "build_campaign_mesh")),
             ("launch/sharding.py", ("plan_cell_tiles",))]
    for rel, pick in pairs:
        want = names(f"repro/{rel}", pick)
        assert want and want <= names(f"repro_torch/{rel}"), rel
    for fn in ("run_campaign", "run_ensemble"):
        want = set(inspect.signature(getattr(jengine, fn)).parameters)
        got = set(inspect.signature(getattr(engine, fn)).parameters)
        assert want - {"backend"} <= got and "device" in got, fn
