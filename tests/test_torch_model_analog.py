"""The slice as a whole: qwen2 smoke (2 layers, d_model 64, vocab 512),
batch 2 x seq 64, the reference's parameters carried across with
``params_from_reference``, every linear through the port's analog modes,
against the JAX reference on the CPU.

Bounds:

* exact logits vs the reference's ``_jitted_ref_forward``: max |d| <= 1e-4
  (measured 5.6e-5 on logits up to 4.6: XLA:CPU fuses multiply-adds and
  sums in another order, ROADMAP C3);
* each of fake, device and bnn vs the reference's same mode:
  KL < 1e-4 and token match 1.0 (measured KL ~1e-8);
* the reference's golden pin on the port: KL at adc 8 / TMR 5.0 = 0.0155
  (rel 0.2), monotone in adc bits; fake vs device on the port KL < 1e-4,
  match 1.0 — in fact bit-identical logits, since the port sizes the fake
  path's ADC full scale and decode gain as the device path does; a second
  device call through the programming cache gives bit-identical logits.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as j_archs
from repro.configs.registry import smoke_config as j_smoke_config
from repro.imc import analog_pipeline as jap
from repro.imc import model_analog as jma
from repro.models import attention as jattn
from repro_torch.configs import registry
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import model_analog as tma
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.common import intercept_linears, linear

BATCH, SEQ = 2, 64
CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def ref_state():
    """The reference's (cfg, params, tokens, ref_logits)."""
    return jma._setup("qwen2-0.5b", True, BATCH, SEQ, 0)


@pytest.fixture(scope="module")
def shared(ref_state):
    """Port model init replaced by the reference's parameters (module-wide,
    so every port entry point that sets up the model gets them)."""
    tree = jax.tree_util.tree_map(np.asarray, ref_state[1])
    mp = pytest.MonkeyPatch()
    mp.setattr(tma, "init_model_params",
               lambda cfg, seed, device: tmodel.params_from_reference(
                   tree, device))
    yield tree
    mp.undo()


@pytest.fixture(scope="module")
def port_state(shared):
    return tma._setup("qwen2-0.5b", True, BATCH, SEQ, 0, CPU)


@pytest.fixture(scope="module")
def port_surface(shared):
    return tma.model_accuracy_surface("qwen2-0.5b", adc_bits=(4, 6, 8),
                                      tmrs=(5.0,), batch=BATCH, seq_len=SEQ,
                                      device=CPU)


def test_configs_match_reference():
    assert list(registry.ARCHS) == list(j_archs)
    for name in j_archs:
        t = dataclasses.asdict(registry.smoke_config(name))
        j = dataclasses.asdict(j_smoke_config(name))
        assert t == j, name
        assert dataclasses.asdict(registry.get_arch(name)) == \
            dataclasses.asdict(jma.get_arch(name)), name
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")


def test_param_tree_matches_reference_shapes(ref_state):
    cfg = registry.smoke_config("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    p = tmodel.init_params(cfg, gen, CPU)
    jp = ref_state[1]
    j_shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
    t_shapes = {path: tuple(leaf.shape) for path, leaf in tma._tree_leaves(p)}
    assert t_shapes == j_shapes
    assert tmodel.n_params(p) == sum(int(np.prod(s)) for s in j_shapes.values())


def test_exact_logits_match_reference(ref_state, port_state):
    cfg, _, tokens, ref_logits = port_state
    assert np.array_equal(_np(tokens), np.asarray(ref_state[2]))
    d = np.abs(_np(ref_logits) - np.asarray(ref_state[3])).max()
    assert d <= 1e-4, d


@pytest.mark.parametrize("mode", ["fake", "device", "bnn"])
def test_modes_match_reference(mode, ref_state, port_state, tmp_path):
    jcfg, jparams, jtokens, _ = ref_state
    cfg, params, tokens, _ = port_state
    yj = jma.analog_model_logits(jparams, jcfg, jtokens,
                                 jap.AnalogConfig(adc_bits=8, tmr=5.0),
                                 mode=mode, cache_dir=str(tmp_path / "j"))
    yt = tma.analog_model_logits(params, cfg, tokens,
                                 tap.AnalogConfig(adc_bits=8, tmr=5.0),
                                 mode=mode, cache_dir=str(tmp_path / "t"),
                                 device=CPU)
    kl, match, _, _ = tma.logit_metrics(np.asarray(yj), yt, tokens)
    assert abs(kl) < 1e-4 and match == 1.0, (kl, match)


def test_golden_kl_pin(port_surface):
    r = next(r for r in port_surface if r.adc_bits == 8)
    assert r.corner == "tt" and r.write_ber == 0.0 and r.tmr == 5.0
    assert r.kl == pytest.approx(0.0155, rel=0.2)
    assert r.token_match > 0.7
    assert abs(np.log(r.ppl_analog / r.ppl_ref)) < 0.05


def test_kl_monotonic_in_adc_bits(port_surface):
    kl = {r.adc_bits: r.kl for r in port_surface}
    assert kl[4] > kl[6] > kl[8], kl
    match = {r.adc_bits: r.token_match for r in port_surface}
    assert match[8] > match[4]


def test_surface_matches_reference(port_surface):
    """The reference's fake surface at the same points, to KL 1e-4."""
    ref = jma.model_accuracy_surface("qwen2-0.5b", adc_bits=(4, 6, 8),
                                     tmrs=(5.0,), batch=BATCH, seq_len=SEQ)
    for rj, rt in zip(ref, port_surface):
        assert (rj.adc_bits, rj.tmr, rj.corner) == (rt.adc_bits, rt.tmr,
                                                    rt.corner)
        assert rt.kl == pytest.approx(rj.kl, abs=1e-4)
        assert rt.token_match == rj.token_match


def test_fake_vs_device_and_cache(port_state, tmp_path):
    cfg, params, tokens, _ = port_state
    acfg = tap.AnalogConfig(adc_bits=8, tmr=5.0)
    y_dev = tma.analog_model_logits(params, cfg, tokens, acfg, mode="device",
                                    cache_dir=str(tmp_path), device=CPU)
    n_entries = len(list(tmp_path.glob("*.npz")))
    assert n_entries == 2 * 7 + 1          # 7 linears per layer + unembed
    y_dev2 = tma.analog_model_logits(params, cfg, tokens, acfg, mode="device",
                                     cache_dir=str(tmp_path), device=CPU)
    assert torch.equal(y_dev, y_dev2)
    y_fake = tma.analog_model_logits(params, cfg, tokens, acfg, device=CPU)
    kl, match, _, _ = tma.logit_metrics(y_dev, y_fake, tokens)
    assert abs(kl) < 1e-4 and match == 1.0, (kl, match)
    # the port sizes the fake path's full scale and decode as the device
    # path does, so the two modes agree bit for bit
    assert torch.equal(y_fake, y_dev)


def test_forward_routes_every_linear(port_state):
    cfg, params, tokens, ref_logits = port_state
    tags = []

    def hook(x2, w, tag):
        tags.append(tag)
        return x2 @ w

    y = tma.model_forward_logits(params, cfg, tokens, hook)
    for t in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert tags.count(t) == cfg.n_layers, (t, tags)
    assert tags.count("unembed") == 1
    assert torch.equal(y, ref_logits)


def test_intercept_scope_and_reshape():
    calls = []

    def hook(x2, w, tag):
        calls.append((tag, tuple(x2.shape)))
        return x2 @ w

    x, w = torch.ones(2, 3, 4), torch.ones(4, 5)
    with intercept_linears(hook):
        y = linear(x, w, "t")
    assert y.shape == (2, 3, 5) and calls == [("t", (6, 4))]
    linear(x, w, "t")
    assert len(calls) == 1


@pytest.mark.parametrize("tie", [1, -1])
def test_bnn_mode_matches_manual_hook(port_state, tie):
    cfg, params, tokens, _ = port_state
    y_mode = tma.analog_model_logits(params, cfg, tokens, tap.AnalogConfig(),
                                     mode="bnn", tie=tie, device=CPU)
    y_hook = tma.model_forward_logits(
        params, cfg, tokens,
        lambda x2, w, tag: tap.binary_matmul(x2, w, tie=tie, device=CPU))
    assert torch.equal(y_mode, y_hook)


def test_mapping_model_surface(port_surface):
    from repro_torch.imc.mapping import accuracy_surface

    surf = accuracy_surface(registry.get_arch("qwen2-0.5b"), adc_bits=(8,),
                            tmrs=(5.0,), model="fake", batch=BATCH,
                            seq_len=SEQ, device=CPU)
    assert set(surf) == {(8, 5.0)}
    r = surf[(8, 5.0)]
    assert r.mode == "fake" and r.arch == "qwen2-0.5b"
    ref = next(q for q in port_surface if q.adc_bits == 8)
    assert r.kl == pytest.approx(ref.kl, rel=1e-6)


# (S, Skv, offset, causal, window, dtype) at a key chunk of 16
CHUNKED_CASES = {
    "causal": (40, 40, 0, True, None, "float32"),
    "window_8": (40, 40, 0, True, 8, "float32"),
    "padding": (37, 37, 0, True, None, "float32"),
    "offset": (24, 40, 16, True, None, "float32"),
    "window_narrow": (48, 48, 0, True, 5, "float32"),
    "window_wide": (48, 48, 0, True, 24, "float32"),
    "noncausal": (40, 40, 0, False, None, "float32"),
    "noncausal_window": (48, 48, 0, False, 20, "float32"),
    "bfloat16": (40, 40, 0, True, None, "bfloat16"),
}
# bf16 q/k/v: the port equals the reference bit for bit here (measured),
# but ``full_attention`` softmaxes in one pass and rounds apart by one bf16
# ulp (0.0156 at |o| in [2, 4))
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_attention_matches_reference(monkeypatch, case):
    """The flash-style path (not on the study's path at seq 64), with a
    small key chunk on both sides, against the reference's and against the
    materialized-score path."""
    import jax.numpy as jnp

    S, Skv, offset, causal, window, dt = CHUNKED_CASES[case]
    monkeypatch.setattr(jattn, "KV_CHUNK", 16)
    monkeypatch.setattr(tattn, "KV_CHUNK", 16)
    cfg = registry.smoke_config("qwen2-0.5b")
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    jcfg = j_smoke_config("qwen2-0.5b")
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    oj = np.asarray(jattn.chunked_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), jcfg, causal=causal, window=window,
        offset=offset).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    ot = tattn.chunked_attention(tq, tk, tv, cfg, causal=causal,
                                 window=window, offset=offset)
    assert ot.dtype == tdt
    ot = _np(ot.float())
    tol = TOL[dt]
    np.testing.assert_allclose(ot, oj, rtol=tol, atol=tol)
    of = _np(tattn.full_attention(tq, tk, tv, cfg, causal=causal,
                                  window=window, offset=offset).float())
    np.testing.assert_allclose(ot, of, rtol=tol, atol=tol)


def test_param_tree_hash_and_programming_key(tmp_path):
    from repro_torch.circuit.bitline import BitlineParams

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))
    t1 = {"x": {"p": a, "q": b}, "y": [a, b]}
    t2 = {"y": [a, b], "x": {"q": b, "p": a}}
    assert tma.param_tree_hash(t1) == tma.param_tree_hash(t2)
    assert tma.param_tree_hash({"x": {"p": a + 1, "q": b}, "y": [a, b]}) \
        != tma.param_tree_hash(t1)
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    bl = BitlineParams(rows=64)
    base = tap.AnalogConfig(adc_bits=6)
    k0 = tma.programming_key(w, "afmtj", base, bl)
    for ro in (dataclasses.replace(base, adc_bits=8),
               dataclasses.replace(base, full_scale_sigmas=6.0),
               dataclasses.replace(base, v_read=0.2)):
        assert tma.programming_key(w, "afmtj", ro, bl) == k0
    for rp in (dataclasses.replace(base, tmr=5.0),
               dataclasses.replace(base, write_ber=0.01),
               dataclasses.replace(base, seed=9),
               dataclasses.replace(base, ir_drop=False)):
        assert tma.programming_key(w, "afmtj", rp, bl) != k0
    assert tma.programming_key(w, "mtj", base, bl) != k0
    assert tma.programming_key(w + 1, "afmtj", base, bl) != k0
    cfg = tap.AnalogConfig(adc_bits=6, tmr=5.0, write_ber=0.01, seed=1)
    a1 = tma.program_weights_cached(w, "afmtj", cfg, cache_dir=str(tmp_path),
                                    device=CPU)
    a2 = tma.program_weights_cached(w, "afmtj", cfg, cache_dir=str(tmp_path),
                                    device=CPU)
    assert torch.equal(a1.g_diff, a2.g_diff)
    for f in ("w_scale", "g_fs", "att_mean", "g_rms"):
        assert getattr(a1, f) == getattr(a2, f), f
