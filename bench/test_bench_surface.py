"""The surface cells at smoke size on the CPU (the program's plain
versions): a whole run of the harness past its look for a card is correct
with the cell's own limits, its result line has the contract's keys, the
control (the reference at the precision below) fails the comparison, and
so does every fault planted under the timed path."""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import faults, harness, smoke  # noqa: E402
from reference import model  # noqa: E402

CELLS = ("qwen2-0.5b.surface-4k", "olmoe-1b-7b.surface-4k")
SMOKE = {"batch": 2, "seq_len": 32, "sample_rows": 16}
CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture
def program(monkeypatch):
    smoke.patch_program(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def execute(cell, seed=2 ** 31 + 7, trace=False):
    c = smoke.smoke_cell(cell, SMOKE)
    return harness.execute(c, seed, 0.5, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(program, cell):
    out = execute(cell)
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"surface_tokens_per_s", "point_ms_p90",
                                   "setup_s"}


def test_traced_run_keys(program):
    out = execute(CELLS[0], trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(program, cell):
    c = smoke.smoke_cell(cell, SMOKE)
    limits = c.limits()
    for seed in (3, 4):
        run = harness.Run(c, seed, 0.0, False, CPU, 0.0)
        got = c.driver().control_readings(run)
        assert any(got[k] > lim for k, lim in limits.items()), got


FAULTS = [pytest.param(CELLS[0], f, id=f) for f in faults.SURFACE
          if f != "dropped_expert"] + [
    pytest.param(CELLS[1], f, id=f"olmoe-{f}")
    for f in ("skipped_site", "dropped_expert")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_fails(program, cell, fault):
    with faults.plant("surface", fault, smoke.smoke_cell(cell, SMOKE).config):
        out = execute(cell, seed=11)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_product_kept(program, cell):
    """The window keeps every crossbar product of each sampled point, and
    the check judges each of them and every layer between them."""
    c = smoke.smoke_cell(cell, SMOKE)
    run = harness.Run(c, 5, 0.0, False, CPU, 0.0)
    got = c.driver().program_readings(run)
    assert got["missing_outputs"] == 0.0
    arch = model.Arch(c.config)
    assert all(set(run.outputs["sites"][k]) == set(model.sites(arch))
               for k in run.sampled)
    for name in ("analog_code_share", "analog_code_gap", "chain_gap_median",
                 "chain_gap_p90", "chain_rows_off"):
        assert got[name] <= c.limits().get(name, float("inf")), (name, got)
