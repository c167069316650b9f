"""The model families beyond attention + dense FFN on the port, against
the JAX reference on the CPU: parameter trees of all ten archs, the
encoder-decoder and frontend pieces, and the linear sites the analog hook
sees (smoke configs, the reference's parameters handed over with
``params_from_reference``).

Bounds:

* parameter trees: equal paths, shapes and dtypes;
* encoder / cross attention, memory K/V, the encoder stack, the cross K/V
  and the frontend embedding: max |d| <= 1e-5 x max |reference| (values
  reach ~60 on unit-normal inputs; measured <= 1.7e-6 of it);
* the list of sites the linear hook sees per forward: equal to the
  reference's, in order (the router, the experts and the Mamba
  projections are not among them on either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.imc import model_analog as jma
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.imc import model_analog as tma
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

PIECE_RTOL = 1e-5
DECODER_ONLY = [a for a in J_ARCHS if not J_ARCHS[a].n_encoder_layers]


def _np(t):
    return t.detach().cpu().numpy()


def _ref_params(arch, seed=0):
    jcfg = j_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, smoke_config(arch), TM.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_tree_matches_reference(arch):
    """``init_params`` builds the reference's tree for every arch (smoke
    config): the same leaf paths, shapes and dtypes."""
    cfg = smoke_config(arch)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = JM.abstract_params(j_smoke(arch))
    j_leaves = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    t_leaves = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for path, t in tma._tree_leaves(p)}
    assert t_leaves == j_leaves
    for name in ("mamba", "router", "shared", "cross", "ln_cross",
                 "encoder"):
        assert any(name in k for k in j_leaves) == \
            any(name in k for k in t_leaves), name


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    d = np.abs(_np(got) - want).max()
    assert d <= PIECE_RTOL * np.abs(want).max(), (what, d)


def test_encoder_and_cross_attention_match_reference():
    jcfg, jp, cfg, tp = _ref_params("seamless-m4t-large-v2")
    B, S, F = 2, 12, cfg.frontend_positions
    x, mem = _x((B, S, cfg.d_model)), _x((B, F, cfg.d_model), 4)
    lj = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["pos0"])
    lt = TM.layer_params(tp, 0)["pos0"]
    pos_j = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    pos_t = torch.broadcast_to(torch.arange(S)[None], (B, S))
    _close(TA.encoder_attention(lt["attn"], torch.from_numpy(x), cfg, pos_t),
           JA.encoder_attention(lj["attn"], jnp.asarray(x), jcfg, pos_j),
           "encoder_attention")
    kj, vj = JA.project_memory_kv(lj["cross"], jnp.asarray(mem), jcfg)
    kt, vt = TA.project_memory_kv(lt["cross"], torch.from_numpy(mem), cfg)
    assert kt.shape == (B, F, cfg.n_kv_heads, cfg.d_head)
    _close(kt, kj, "memory k")
    _close(vt, vj, "memory v")
    _close(TA.cross_attention(lt["cross"], torch.from_numpy(x), kt, vt, cfg),
           JA.cross_attention(lj["cross"], jnp.asarray(x), kj, vj, jcfg),
           "cross_attention")


def test_encode_and_cross_kv_match_reference():
    jcfg, jp, cfg, tp = _ref_params("seamless-m4t-large-v2")
    frames = _x((2, cfg.frontend_positions, cfg.d_model))
    ej = JM._encode(jp, jcfg, jnp.asarray(frames))
    et = TM._encode(tp, cfg, torch.from_numpy(frames))
    _close(et, ej, "_encode")
    kvj = JM._cross_kv(jp, jcfg, ej)
    kvt = TM._cross_kv(tp, cfg, et)
    assert set(kvt) == set(kvj) == {"pos0"}
    for i, name in enumerate("kv"):
        assert kvt["pos0"][i].shape == kvj["pos0"][i].shape
        _close(kvt["pos0"][i], kvj["pos0"][i], f"cross {name}")


def test_embed_with_frontends_matches_reference():
    jcfg, jp, cfg, tp = _ref_params("qwen2-vl-2b")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10))
    fe = _x((2, cfg.frontend_positions, cfg.d_model))
    xj = JM._embed(jp, jcfg, jnp.asarray(toks, np.int32), jnp.asarray(fe))
    xt = TM._embed(tp, cfg, torch.from_numpy(toks), torch.from_numpy(fe))
    assert xt.shape == (2, cfg.frontend_positions + 10, cfg.d_model)
    _close(xt, xj, "_embed")
    np.testing.assert_array_equal(_np(xt[:, :cfg.frontend_positions]), fe)


def _tags(forward, params, cfg, tokens):
    tags = []

    def hook(x2, w, tag):
        tags.append((tag, tuple(w.shape)))
        return x2 @ w

    forward(params, cfg, tokens, hook)
    return tags


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_hook_sites_match_reference(arch):
    """The port routes exactly the reference's linear sites (tag and weight
    shape, in order): olmoe 2 x 4 + 1, mamba2 the tied unembed only."""
    jcfg, jp, cfg, tp = _ref_params(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8))
    ref = _tags(jma.model_forward_logits, jp, jcfg,
                jnp.asarray(toks, np.int32))
    got = _tags(tma.model_forward_logits, tp, cfg, torch.from_numpy(toks))
    assert got == ref
    want = {"olmoe-1b-7b": 2 * 4 + 1, "mamba2-780m": 1,
            "jamba-1.5-large-398b": 4 + 4 * 3 + 1}
    if arch in want:
        assert len(got) == want[arch], got
    assert all(tag not in ("router", "w_z", "w_xbc", "w_dt", "w_out")
               for tag, _ in got)


def test_analog_path_refuses_encoder_decoder():
    cfg = smoke_config("seamless-m4t-large-v2")
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(AssertionError, match="decoder-only"):
        tma.model_forward_logits(p, cfg, torch.zeros(1, 4, dtype=torch.long))


def test_accuracy_twin_sweeps_the_reference_archs():
    """``examples/torch_model_accuracy_study.py`` sweeps what
    ``examples/model_accuracy_study.py`` sweeps."""
    import importlib.util
    from pathlib import Path

    examples = Path(__file__).resolve().parents[1] / "examples"
    mods = {}
    for name in ("model_accuracy_study", "torch_model_accuracy_study"):
        spec = importlib.util.spec_from_file_location(
            name, examples / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    for attr in ("SWEEP_ARCHS", "ADC_BITS", "TMRS", "CORNERS", "WRITE_BERS",
                 "BATCH", "SEQ_LEN"):
        assert getattr(mods["torch_model_accuracy_study"], attr) == \
            getattr(mods["model_accuracy_study"], attr), attr


def test_params_from_reference_keeps_bfloat16():
    """jamba / llama4 keep bfloat16 parameters at full width; numpy holds
    them as ml_dtypes' bfloat16, which ``torch.from_numpy`` refuses."""
    tree = {"a": np.asarray(jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16)),
            "b": {"c": np.ones((2,), np.float32)}}
    t = TM.params_from_reference(tree, "cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"]["c"].dtype == \
        torch.float32
    assert t["a"].tolist() == [1.5, -2.0, 3.25]
