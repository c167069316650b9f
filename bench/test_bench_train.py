"""The training cell at smoke size on the CPU: a run of the harness past
its look for a card is correct with the cell's own limits, the control
fails, and so does every fault planted in the step."""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import faults, harness, smoke  # noqa: E402

CELL = "qwen2-0.5b.train-4k"
TRAIN = {"seq_len": 32}
CPU = torch.device("cpu")


@pytest.fixture
def program(monkeypatch):
    smoke.patch_program(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def execute(seed=2 ** 31 + 9):
    c = smoke.smoke_cell(CELL, train=TRAIN)
    return harness.execute(c, seed, 0.2, False, CPU, time.perf_counter())


def test_run_is_correct(program):
    out = execute()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_control_fails(program):
    """The control computes in fp8 below the configuration's bfloat16 (the
    reference alone runs, so the smoke model keeps the stated precision)."""
    c = smoke.smoke_cell(CELL, train=TRAIN)
    c.config["precision"] = dict(c.config["precision"],
                                 compute_dtype="bfloat16")
    limits = c.limits()
    for seed in (3, 4):
        got = c.driver().control_readings(
            harness.Run(c, seed, 0.0, False, CPU, 0.0))
        assert any(got[k] > lim for k, lim in limits.items()), got


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_fault_fails(program, fault):
    with faults.plant("train", fault, smoke.smoke_cell(CELL).config):
        out = execute(seed=13)
    assert not out["correct"], (fault, out["checks"])
