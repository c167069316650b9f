"""The port's train step and trainer on the CPU: the chunked
cross-entropy and padded labels against the reference, ``make_train_step``
(1 and 2 microbatches, 3 steps from the reference's parameters) against
the reference's unsharded ``jax.jit(make_train_step(...))`` on the same
pipeline batches, and the port's ``launch.train.main`` with ``--device
cpu`` in the counterparts of the reference's trainer tests
(``tests/test_system.py``: the loss drops over 100 steps, resume, olmoe
with 2 microbatches).

Bounds of the train step (ROADMAP C16):

* loss: rtol 1e-6 (measured <= 1.5e-7); learning rate equal;
* gradient norm: rtol 2e-4 (measured <= 6.5e-5: qwen2's embedding
  gradient carries C16's amplified rounding);
* parameters: max |d| <= 1e-5, under a twentieth of one step's largest
  move (AdamW's early steps move an element by about lr x sign(g), so an
  element whose gradient sign differs between the two would move 2e-4
  apart here), and at most 3% of all elements more than 1e-6 relative
  apart (measured 3.2e-6 and 1.5%: the steps' small moves differ where
  the gradients do, most of all on the zero-initialized norm scales and
  biases);
* moments m and v: max |d| <= 1e-3 x the leaf's largest |value|
  (measured <= 3.8e-4, the gradients' own spread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro.launch import steps as JST
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_init
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import steps as ST
from repro_torch.launch.train import main
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init

from test_torch_train import _batch, _hold

STEP_LOSS_RTOL = 1e-6
NORM_RTOL = 2e-4
PARAM_ATOL = 1e-5
PARAM_SHARE = 0.03
MOMENT_RTOL = 1e-3


def test_padded_labels_are_masked():
    """Labels -1 carry no loss on either side: the token count drops and
    the loss is the mean over the rest."""
    arch = "qwen2-0.5b"
    batch = _batch(j_smoke(arch))
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, -5:] = -1
    _hold(arch, batch)
    cfg = smoke_config(arch)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, met = TM.forward_train(tp, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert met["tokens"].item() == batch["labels"].size - 10


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_chunked_loss_matches_reference(arch, monkeypatch):
    """LOSS_CHUNK 8 at S = 32: four checkpointed chunks on both sides (the
    24 text positions after qwen2-vl's 8 frontend positions: three)."""
    monkeypatch.setattr(JM, "LOSS_CHUNK", 8)
    monkeypatch.setattr(TM, "LOSS_CHUNK", 8)
    _hold(arch, _batch(j_smoke(arch)))


def _leaves_close(j_tree, t_tree, what):
    off = n = 0
    for a, b in zip(jax.tree_util.tree_leaves(j_tree), tree_leaves(t_tree)):
        a = np.asarray(a, np.float64)
        d = np.abs(a - b.detach().double().numpy())
        if what == "params":
            assert d.max() <= PARAM_ATOL, d.max()
            off += (d > 1e-6 * np.abs(a)).sum()
            n += a.size
        else:
            assert d.max() <= MOMENT_RTOL * np.abs(a).max(), what
    assert off <= PARAM_SHARE * n, off / n


@pytest.mark.parametrize("arch,micro", [("qwen2-0.5b", 1),
                                        ("qwen2-0.5b", 2),
                                        ("olmoe-1b-7b", 2)])
def test_train_step_matches_reference_jit(arch, micro):
    """Three steps (lr 0, 1e-4, 2e-4 of the warmup) from the reference's
    parameters on the same batches (B 4 x S 32)."""
    B, S = 4, 32
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    jm, jv = j_init(jp, jcfg.opt_state_dtype)
    tm, tv = adamw_init(tp, cfg.opt_state_dtype)
    jstep = jax.jit(JST.make_train_step(
        jcfg, JShape("t", "train", S, B, microbatches=micro),
        JAdamW(lr=1e-2), total_steps=10))
    tstep = ST.make_train_step(
        cfg, ShapeConfig("t", "train", S, B, microbatches=micro),
        AdamWConfig(lr=1e-2), total_steps=10)
    pipe = j_make_pipeline(JDataConfig(vocab=jcfg.vocab, seq_len=S,
                                       global_batch=B, microbatches=micro))
    j_s, t_s = jnp.zeros((), jnp.int32), 0
    for _ in range(3):
        b = next(pipe)
        jp, jm, jv, j_s, jmet = jstep(jp, jm, jv, j_s,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()})
        tp, tm, tv, t_s, tmet = tstep(tp, tm, tv, t_s,
                                      {k: torch.from_numpy(v) for k, v in
                                       b.items()})
        assert t_s == int(j_s)
        assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]),
                                                    rel=STEP_LOSS_RTOL)
        assert tmet["grad_norm"].item() == pytest.approx(
            float(jmet["grad_norm"]), rel=NORM_RTOL)
        assert tmet["lr"].item() == float(jmet["lr"])
        _leaves_close(jp, tp, "params")
        _leaves_close(jm, tm, "m")
        _leaves_close(jv, tv, "v")
    assert float(jmet["lr"]) > 0.0


def test_microbatch_mean_gradient_is_whole_batch_gradient():
    """Two microbatches of one token count each: their mean gradient is
    the whole batch's (rtol 1e-5 of each leaf's max; the two orders of
    summation differ)."""
    cfg = smoke_config("qwen2-0.5b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _batch(cfg, S=32, B=4)
    whole = {k: torch.from_numpy(v)[None] for k, v in b.items()}
    split = {k: torch.from_numpy(v).reshape(2, 2, *v.shape[1:])
             for k, v in b.items()}
    l1, g1 = ST.make_grad_step(cfg, ShapeConfig("w", "train", 32, 4))(
        params, whole)
    l2, g2 = ST.make_grad_step(
        cfg, ShapeConfig("s", "train", 32, 4, microbatches=2))(params, split)
    assert l2.item() == pytest.approx(l1.item(), rel=1e-6)
    for a, b_ in zip(tree_leaves(g1), tree_leaves(g2)):
        assert (a - b_).abs().max() <= 1e-5 * a.abs().max()


# --- the reference's trainer tests (tests/test_system.py) on the port -------

def test_train_loss_decreases(tmp_path):
    history = main([
        "--arch", "qwen2-0.5b", "--preset", "smoke", "--steps", "100",
        "--batch", "8", "--seq", "64", "--lr", "1e-2",
        "--ckpt-dir", str(tmp_path), "--log-every", "2", "--device", "cpu",
    ])
    losses = [l for _, l in history]
    assert len(losses) >= 10
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_train_resume(tmp_path):
    main(["--arch", "qwen2-0.5b", "--preset", "smoke", "--steps", "10",
          "--batch", "4", "--seq", "32", "--save-every", "5",
          "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    h = main(["--arch", "qwen2-0.5b", "--preset", "smoke", "--steps", "14",
              "--batch", "4", "--seq", "32", "--save-every", "5",
              "--ckpt-dir", str(tmp_path), "--log-every", "1",
              "--device", "cpu"])
    steps = [s for s, _ in h]
    assert min(steps) >= 10, steps


def test_train_microbatched_matches_shape(tmp_path):
    h = main(["--arch", "olmoe-1b-7b", "--preset", "smoke", "--steps", "6",
              "--batch", "8", "--seq", "32", "--microbatches", "2",
              "--ckpt-dir", str(tmp_path), "--log-every", "1",
              "--device", "cpu"])
    assert len(h) >= 3
    assert all(np.isfinite(l) for _, l in h)


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    """Stopped at step 2 and resumed, a run ends on the parameters and
    moments of one that was not, bit for bit on the CPU (the resumed run
    continues the data stream at the checkpoint's step)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.train import train

    cfg = smoke_config("qwen2-0.5b")
    shape = ShapeConfig("r", "train", 16, 4, microbatches=2)
    opt = AdamWConfig(lr=1e-2)
    kw = dict(save_every=2, device="cpu", step0=100, total_steps=10000)
    train(cfg, shape, opt, 104, tmp_path / "a", **kw)
    train(cfg, shape, opt, 102, tmp_path / "b", **kw)
    h = train(cfg, shape, opt, 104, tmp_path / "b", log_every=1, **kw)
    assert [r.step for r in h] == [102, 103]
    assert all(r.lr == pytest.approx(1e-2) for r in h)
    like = Checkpointer(tmp_path / "a" / cfg.name).restore(
        104, {"params": TM.init_params(cfg, torch.Generator(), "cpu")})
    a = Checkpointer(tmp_path / "a" / cfg.name)
    b = Checkpointer(tmp_path / "b" / cfg.name)
    assert a.steps() == b.steps() == [102, 104]
    ta = a.restore(104, like)
    tb = b.restore(104, like)
    for x, y in zip(tree_leaves(ta), tree_leaves(tb)):
        assert torch.equal(x, y)
