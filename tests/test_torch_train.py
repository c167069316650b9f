"""The port's training loss and its gradient against the JAX reference on
the CPU: ``forward_train`` of all ten archs (smoke configs, the
reference's parameters through ``params_from_reference``, batches from the
shared data pipeline with frontend embeddings or encoder frames where the
arch has them) against ``jax.value_and_grad(M.forward_train)``, loss and
every gradient leaf.  The chunked cross-entropy, padded labels and the
train step are held in ``test_torch_train_steps.py``.

Bounds:

* loss: rtol 2e-6 (measured <= 5.2e-7);
* the MoE aux loss: rtol 1e-5;
* each gradient leaf: max |d| <= 2e-3 x the leaf's largest |reference
  gradient| (jamba 4e-3, ROADMAP C14).  Measured up to 9.4e-4 (gemma2,
  the embedding), 9.0e-4 (jamba), 8.2e-4 (llama4).  Both sides are
  float32 rounding of an ill-conditioned backward (ROADMAP C15: the
  reference's init gives the smoke models' stacked weights std
  1/sqrt(2)), which the test checks against a float64 evaluation of the
  port's algorithm: there the reference's own gradients sit up to 8.0e-4
  (jamba) and 5.9e-4 (gemma2) of the leaf's max, the port's 1.3e-3 /
  3.5e-4 (ROADMAP C16); the reference's gap is held at most 3x the
  port's (+ 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.data import DataConfig
from repro.data import make_pipeline
from repro.models import model as JM
from repro_torch._tree import tree_leaves_with_paths, tree_map
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

LOSS_RTOL = 2e-6
GRAD_RTOL = 2e-3
GRAD_RTOL_JAMBA = 4e-3          # ROADMAP C14


def _batch(cfg, S=32, B=2, seed=0):
    """One microbatch of the shared pipeline (text positions S less the
    frontend positions for decoder-only archs)."""
    text = S if cfg.n_encoder_layers else S - cfg.frontend_positions
    b = next(make_pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=text, global_batch=B, seed=seed,
        frontend_positions=cfg.frontend_positions, d_model=cfg.d_model,
        encoder_frames=bool(cfg.n_encoder_layers))))
    return {k: v[0] for k, v in b.items()}


def _reference(arch, batch):
    jcfg = j_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return jp, float(loss), metrics, grads


def _port(arch, jp, batch, dtype=torch.float32):
    """The port's loss, metrics, leaf paths and gradients; with ``dtype``
    float64 every float32 of its model modules, the parameters and the
    inputs are widened (the same algorithm in float64)."""
    cfg = smoke_config(arch)
    mods = (TC, TA, TF, TS, TM)
    saved = [m._F32 for m in mods], TC.DTYPES["float32"]
    for m in mods:
        m._F32 = dtype
    TC.DTYPES["float32"] = dtype
    try:
        tp = tree_map(lambda t: t.to(dtype), TM.params_from_reference(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
        items = tree_leaves_with_paths(tp)
        leaves = [t.requires_grad_() for _, t in items]
        loss, metrics = TM.forward_train(tp, cfg, {
            k: torch.from_numpy(v).to(dtype if v.dtype == np.float32
                                      else torch.int64)
            for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for m, f in zip(mods, saved[0]):
            m._F32 = f
        TC.DTYPES["float32"] = saved[1]
    return loss, metrics, [p for p, _ in items], grads


def _hold(arch, batch):
    jp, jloss, jmet, jgrads = _reference(arch, batch)
    loss, metrics, paths, grads = _port(arch, jp, batch)
    assert loss.item() == pytest.approx(jloss, rel=LOSS_RTOL)
    assert metrics["tokens"].item() == float(jmet["tokens"])
    assert metrics["aux"].item() == pytest.approx(float(jmet["aux"]),
                                                  rel=1e-5, abs=1e-9)
    j_items = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [tuple(getattr(k, "key", k) for k in p) for p, _ in j_items] == \
        paths
    bound = GRAD_RTOL_JAMBA if arch.startswith("jamba") else GRAD_RTOL
    for (path, want), got in zip(j_items, grads):
        want = np.asarray(want)
        assert got is not None, path
        got = got.numpy()
        assert np.isfinite(got).all(), path
        assert np.abs(got - want).max() <= bound * np.abs(want).max(), \
            (jax.tree_util.keystr(path),
             np.abs(got - want).max() / np.abs(want).max())
    return jp, jloss, grads, jgrads


def _gap(a, b):
    """Largest over leaves of max |a - b| / max |b|."""
    return max(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)
               for x, y in zip(a, b))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_forward_train_loss_and_every_gradient_match_reference(arch):
    """Then the gap is rounding, not a difference of algorithm: the
    reference's float32 gradients sit no further from the port's algorithm
    evaluated in float64 than 3x the port's own float32 gradients do (+
    1e-6).  ``-s`` prints the three gaps (ROADMAP C16)."""
    batch = _batch(j_smoke(arch))
    jp, jloss, grads, jgrads = _hold(arch, batch)
    l64, _, _, g64 = _port(arch, jp, batch, torch.float64)
    ref = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(
        jgrads)]
    g32 = [g.double().numpy() for g in grads]
    g64 = [g.double().numpy() for g in g64]
    port_ref, ref_64, port_64 = _gap(g32, ref), _gap(ref, g64), _gap(g32,
                                                                     g64)
    print(f"{arch}: loss vs float64 {abs(l64.item() - jloss) / jloss:.2e}; "
          f"gradients port vs ref {port_ref:.2e}, ref vs float64 "
          f"{ref_64:.2e}, port vs float64 {port_64:.2e}")
    assert ref_64 <= 3 * port_64 + 1e-6
