"""The port's training substrate on the CPU: the data pipeline equal to the
reference's (``==``), the step watchdog and the fault-tolerant loop (the
reference's cases of ``tests/test_runtime.py`` and
``tests/test_substrate.py``), and the torch-native checkpointer (round
trip, GC, atomic publish, async save, resume through the loop, the
reference's manifest paths).  Every test that installs the SIGTERM handler
restores the previous one."""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, batch_at, make_pipeline
from repro_torch.runtime import FaultTolerantLoop, StepWatchdog


# ----------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=32, global_batch=4, seed=7),
    dict(vocab=151936, seq_len=64, global_batch=8, microbatches=2, seed=3),
    dict(vocab=512, seq_len=16, global_batch=8, microbatches=2,
         host_rank=1, host_count=2),
    dict(vocab=512, seq_len=24, global_batch=4, frontend_positions=8,
         d_model=16),
    dict(vocab=512, seq_len=24, global_batch=4, microbatches=2,
         frontend_positions=8, d_model=16, encoder_frames=True),
], ids=["plain", "big-vocab-mb2", "host1of2", "frontend", "encoder"])
def test_pipeline_equals_reference(kw):
    ref = j_make_pipeline(JDataConfig(**kw))
    port = make_pipeline(DataConfig(**kw))
    for step in range(3):
        want, got = next(ref), next(port)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (k, step)
        for k in want:
            assert np.array_equal(batch_at(DataConfig(**kw), step)[k],
                                  want[k])


def test_pipeline_memmap_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 70000, 5000).astype(
        np.uint32).tofile(path)
    kw = dict(vocab=70000, seq_len=32, global_batch=4, microbatches=2,
              source="memmap", path=str(path), host_rank=1, host_count=2)
    ref, port = j_make_pipeline(JDataConfig(**kw)), make_pipeline(
        DataConfig(**kw))
    for _ in range(4):
        want, got = next(ref), next(port)
        for k in want:
            assert np.array_equal(got[k], want[k])


def test_pipeline_deterministic():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=7)
    b1 = next(make_pipeline(cfg))
    b2 = next(make_pipeline(cfg))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4, microbatches=2)
    b = next(make_pipeline(cfg))
    assert b["tokens"].shape == (2, 2, 16)
    np.testing.assert_array_equal(b["tokens"][..., 1:],
                                  b["labels"][..., :-1])
    with pytest.raises(ValueError, match="does not split"):
        next(make_pipeline(DataConfig(vocab=10, seq_len=4, global_batch=3,
                                      microbatches=2)))


# -------------------------------------------------------------------- runtime
class FakeCkpt:
    def __init__(self):
        self.saves = []
        self.waited = False

    def save(self, step, state, blocking=False):
        self.saves.append((step, blocking))

    def wait(self):
        self.waited = True


def test_watchdog_first_observation_seeds_ewma():
    wd = StepWatchdog(threshold=2.0, alpha=0.1)
    assert wd.observe(0, 5.0) is False
    assert wd.ewma == 5.0 and wd.straggler_steps == []


def test_watchdog_flags_straggler_and_clamps_ewma():
    wd = StepWatchdog(threshold=2.0, alpha=0.1)
    wd.observe(0, 1.0)
    assert wd.observe(1, 100.0) is True
    assert wd.straggler_steps == [1]
    assert wd.ewma == 0.9 * 1.0 + 0.1 * 2.0
    assert wd.observe(2, 1.0) is False


def test_watchdog_tracks_gradual_slowdown():
    wd = StepWatchdog(threshold=2.0, alpha=0.5)
    for i, dt in enumerate((1.0, 1.2, 1.4, 1.5)):
        assert wd.observe(i, dt) is False
    assert wd.ewma > 1.0


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=2.0)
    for s in range(10):
        assert not wd.observe(s, 1.0)
    assert wd.observe(10, 5.0)
    assert wd.straggler_steps == [10]
    assert not wd.observe(11, 1.0)


def test_sigterm_uninstall_restores_previous_handler():
    sentinel = lambda signum, frame: None     # noqa: E731
    prev = signal.signal(signal.SIGTERM, sentinel)
    try:
        loop = FaultTolerantLoop(FakeCkpt())
        loop.install_sigterm()
        assert signal.getsignal(signal.SIGTERM) is not sentinel
        loop.uninstall_sigterm()
        assert signal.getsignal(signal.SIGTERM) is sentinel
        loop.uninstall_sigterm()              # idempotent
        assert signal.getsignal(signal.SIGTERM) is sentinel
        with FaultTolerantLoop(FakeCkpt()):
            assert signal.getsignal(signal.SIGTERM) is not sentinel
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_preemption_triggers_final_blocking_checkpoint():
    ckpt = FakeCkpt()
    prev = signal.getsignal(signal.SIGTERM)
    with FaultTolerantLoop(ckpt, save_every=100) as loop:
        def step_fn(state, batch):
            if state == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state + 1, {}

        state, step, _ = loop.run(0, step_fn, lambda s: {}, start_step=0,
                                  total_steps=50)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert loop.preempted and step < 50
    assert ckpt.saves and ckpt.saves[-1][1] is True
    assert ckpt.waited


def test_clean_run_saves_periodically_no_final_blocking():
    ckpt = FakeCkpt()
    loop = FaultTolerantLoop(ckpt, save_every=2)
    state, step, wd = loop.run(0, lambda s, b: (s + 1, {}), lambda s: {},
                               start_step=0, total_steps=6)
    assert step == 6 and state == 6 and not loop.preempted
    assert ckpt.saves == [(2, False), (4, False), (6, False)]
    assert ckpt.waited


# ----------------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16),
                       "a": torch.full((2,), -1.5)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path)
    ck.save(7, tree, blocking=True)
    assert ck.latest_step() == 7
    out = ck.restore(7, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert int(out["step"]) == 7 and out["step"].dtype == torch.int32
    assert list(out["nested"]) == ["b", "a"]          # like's structure


def test_checkpoint_manifest_matches_reference_layout(tmp_path):
    """Leaf paths joined with '/' in the reference's (sorted) order, with
    shape and dtype."""
    tree = _tree()
    Checkpointer(tmp_path).save(3, tree, blocking=True)
    man = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    ref_paths, ref_leaves, _ = _flatten_with_paths(
        jax.tree_util.tree_map(lambda t: t.float().numpy(), tree))
    assert [x["path"] for x in man["leaves"]] == ref_paths
    assert [x["shape"] for x in man["leaves"]] == [list(a.shape)
                                                   for a in ref_leaves]
    assert [x["dtype"] for x in man["leaves"]] == [
        "float32", "float32", "bfloat16", "int32"]
    assert man["step"] == 3 and man["host_count"] == 1


def test_checkpoint_gc_and_async(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert sorted(ck.steps()) == [3, 4]


def test_checkpoint_atomic(tmp_path):
    """A leftover .tmp dir is never visible as a checkpoint."""
    ck = Checkpointer(tmp_path)
    (tmp_path / "step_9.tmp").mkdir()
    assert ck.latest_step() is None
    ck.save(2, {"x": torch.ones(1)}, blocking=True)
    assert ck.steps() == [2]


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """The host copy is taken before ``save`` returns: an in-place update
    right after it does not reach the file; the restore lands on the
    requested device."""
    x = torch.arange(6, dtype=torch.float32)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": x})
    x.add_(100.0)
    ck.wait()
    out = ck.restore(1, {"x": x}, device="cpu")
    assert torch.equal(out["x"], torch.arange(6, dtype=torch.float32))
    with pytest.raises(KeyError, match="no leaf"):
        ck.restore(1, {"y": x})


def test_checkpoint_write_failure_surfaces_in_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.ones(1)})
    ck.wait()
    (tmp_path / "step_2.tmp").write_text("a file where a directory goes")
    ck.dir = tmp_path / "step_2.tmp" / "sub"       # unwritable target
    ck.save(2, {"x": torch.ones(1)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                      # reported once


def test_fault_loop_resumes(tmp_path):
    """Stop the loop mid-run; a new loop resumes from the checkpoint."""
    ck = Checkpointer(tmp_path)

    def step_fn(state, batch):
        return state + 1, {"loss": float(state)}

    loop = FaultTolerantLoop(ck, save_every=5)
    state, step, _ = loop.run(torch.tensor(0), step_fn, lambda s: {}, 0, 12)
    assert int(state) == 12
    assert ck.latest_step() == 10
    restored = ck.restore(10, torch.tensor(0))
    assert int(restored) == 10
    loop2 = FaultTolerantLoop(ck, save_every=5)
    state2, step2, _ = loop2.run(restored, step_fn, lambda s: {}, 10, 12)
    assert int(state2) == 12 and step2 == 12
