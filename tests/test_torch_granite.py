"""granite-4.0-h-small (a port-only arch: Mamba-2 + NoPE attention 1 in 10,
72-expert MoE with a shared expert, muP multipliers) against the plain
reference of the benchmark, ``bench/reference/hybrid.py`` (plain torch,
written from HF ``granitemoehybrid``), at the smoke size on seeded random
weights: the exact logits, the analog forward under a deterministic hook
product by product, prefill plus decode through the cache, one training
step, and the shared expert at its own width.  A forward that drops a
multiplier or the conv bias, keeps RoPE, or runs in bf16 fails the
tolerance."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bench"))

from reference import hybrid  # noqa: E402
from reference.precision import Precision  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.imc import model_analog as ma  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402

NAME = "granite-4.0-h-small-1period"
# float32 logits of the port and the reference agree to 2.5e-5-4.8e-5 of
# their largest magnitude on these draws: the port's scan takes exp of a
# difference of two within-chunk cumsums of dt A, which reach ~1e2, so a
# float32 ulp of each is ~1e-5 of a decay; the reference sums the segment
# directly.  2e-4 is 4x the largest; every departure below moves the
# logits by 0.07 or more (>300x).
RTOL = 2e-4
# decode's O(1) recurrence (one decay per step) against the chunked scan
DECODE_RTOL = 5e-4


def smoke():
    return registry.smoke_config(NAME)


def conf_of(cfg) -> dict:
    """The reference's configuration file (HF keys) of a port config."""
    sw = cfg.port
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "layer_types": ["attention" if m == "attn" else "mamba"
                        for m, _ in cfg.pattern] * cfg.n_pattern_repeats,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.d_head,
        "intermediate_size": cfg.moe.d_expert,
        "shared_intermediate_size": cfg.shared_width,
        "num_local_experts": cfg.moe.num_experts,
        "num_experts_per_tok": cfg.moe.top_k, "vocab_size": cfg.vocab,
        "tie_word_embeddings": cfg.tie_embeddings,
        "rms_norm_eps": cfg.norm_eps,
        "precision": {"compute_dtype": cfg.compute_dtype},
        "attention_multiplier": sw.score_scale,
        "embedding_multiplier": sw.embed_scale,
        "residual_multiplier": sw.residual_scale,
        "logits_scaling": sw.logits_scaling,
        "position_embedding_type": "nope",
        "mamba_n_heads": cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim,
        "mamba_d_head": cfg.ssm.headdim, "mamba_d_state": cfg.ssm.d_state,
        "mamba_d_conv": cfg.ssm.d_conv, "mamba_chunk_size": cfg.ssm.chunk,
        "mamba_expand": cfg.ssm.expand, "mamba_n_groups": 1,
        "mamba_conv_bias": sw.conv_bias,
        "routing": {"group_tokens": 1024, "capacity_factor": 1.25,
                    "min_capacity": 4, "dropless_up_to_tokens": 64},
    }


def random_params(cfg, seed: int = 0):
    """The port's tree with every leaf drawn (the init leaves norms, biases
    and D at constants): norm offsets and biases N(0, 0.1), ``a_log`` log
    U[1, 16], ``dt_bias`` softplus^-1 of dt log-uniform in [1e-3, 1e-1],
    ``d_skip`` 1 + N(0, 0.1), the conv N(0, 1/(3 d_conv))."""
    g = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, g, "cpu")

    def fill(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, path + (k,))
                continue
            if k == "a_log":
                v.copy_(torch.empty_like(v).uniform_(1.0, 16.0,
                                                     generator=g).log())
            elif k == "dt_bias":
                dt = torch.empty_like(v).uniform_(
                    math.log(1e-3), math.log(1e-1), generator=g).exp()
                v.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif k == "d_skip":
                v.copy_(1.0 + 0.1 * torch.randn(v.shape, generator=g))
            elif k in ("conv_w", "conv_b"):
                std = (3 * cfg.ssm.d_conv) ** -0.5
                v.copy_(std * torch.randn(v.shape, generator=g))
            elif k in ("ln1", "ln2", "norm", "final_norm"):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
    fill(params)
    return params


def tokens(B=2, S=32, seed=1):
    return torch.randint(0, smoke().vocab, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def reference(cfg, params, hook=None):
    return hybrid.Model(hybrid.Arch(conf_of(cfg)), params,
                        Precision("stated"), linear_hook=hook)


def gap(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def test_port_only_table():
    assert NAME not in registry.ARCHS and len(registry.ARCHS) == 10
    full = registry.get_arch("granite-4.0-h-small")
    assert registry.get_arch(NAME).n_layers == 10 and full.n_layers == 40
    assert [m for m, _ in full.pattern].count("attn") == 1
    assert full.shared_width == 1536 and full.moe.d_expert == 768
    # 32B total, a stage of one period 8.36e9 (the card's share)
    assert 32.1e9 < full.param_count() < 32.3e9
    assert 8.35e9 < registry.get_arch(NAME).param_count() < 8.36e9
    # the reference archs keep their fields: the switches are not fields
    assert "port" not in {f.name for f in dataclasses.fields(
        registry.get_arch("jamba-1.5-large-398b"))}


def test_exact_logits_match_reference():
    cfg = smoke()
    p, t = random_params(cfg), tokens()
    got = ma.model_forward_logits(p, cfg, t)
    assert gap(got, reference(cfg, p).forward_logits(t)) < RTOL


def _scaled_hook(calls):
    """A deterministic hook: each tag's product times its own factor, so a
    product reached under another tag or out of order shows."""
    factor = {"wq": 0.9, "wk": 1.1, "wv": 0.8, "wo": 1.2, "w_gate": 0.7,
              "w_up": 1.3, "w_down": 0.6, "unembed": 1.4}

    def hook(x, w, tag):
        calls.append((tag, x.clone()))
        return (x.float() @ w.float()) * factor[tag]
    return hook


def test_analog_forward_product_by_product():
    cfg = smoke()
    p, t = random_params(cfg), tokens()
    mine, ref = [], []
    got = ma.model_forward_logits(p, cfg, t, _scaled_hook(mine))
    want = reference(cfg, p, _scaled_hook(ref)).forward_logits(t)
    arch = hybrid.Arch(conf_of(cfg))
    assert [c[0] for c in mine] == [c[0] for c in ref] == [
        tag for tag, _ in hybrid.sites(arch)]
    assert len(mine) == 4 + 3 * cfg.n_layers + 1
    for (tag, x), (_, y) in zip(mine, ref):
        assert gap(x, y) < RTOL, tag
    assert gap(got, want) < RTOL


def test_prefill_and_decode_match_reference_forward():
    cfg = smoke()
    p, t = random_params(cfg), tokens(S=32)
    ref = reference(cfg, p).forward_logits(t)
    S0 = 28                     # not a chunk multiple: the padded prefill
    with torch.no_grad():
        logits, cache = M.serve_prefill(p, cfg, {"tokens": t[:, :S0]}, 32)
        assert gap(logits[:, 0], ref[:, S0 - 1]) < DECODE_RTOL
        for s in range(S0, 32):
            logits, cache = M.serve_step(p, cfg, cache, t[:, s:s + 1])
            assert gap(logits[:, 0], ref[:, s]) < DECODE_RTOL, s


def test_one_training_step():
    cfg = smoke()
    B, S = 4, 32
    p = random_params(cfg)
    t = tokens(B, S, seed=2)
    labels = torch.roll(t, -1, dims=1)
    # the loss's cross-entropy is the reference's logits' (the logits over
    # logits_scaling in the loss too)
    ce = F.cross_entropy(reference(cfg, p).forward_logits(t).reshape(
        -1, cfg.vocab), labels.reshape(-1))
    _, out = M.forward_train(p, cfg, {"tokens": t, "labels": labels})
    assert float(out["ce"]) == pytest.approx(float(ce), rel=RTOL)
    m, v = adamw_init(p, cfg.opt_state_dtype)
    step = ST.make_train_step(cfg, ShapeConfig("t", "train", S, B,
                                               microbatches=2),
                              AdamWConfig(lr=1e-2), total_steps=1000)
    batch = {"tokens": t.reshape(2, B // 2, S).int(),
             "labels": labels.reshape(2, B // 2, S).int()}
    before = {k: x.clone() for k, x in _leaves(p)}
    # step 50 of the warm-up: a learning rate above 0
    new, _, _, i, met = step(p, m, v, 50, batch)
    assert i == 51 and float(met["lr"]) > 0.0
    assert math.isfinite(float(met["loss"]))
    assert math.isfinite(float(met["grad_norm"])) and float(
        met["grad_norm"]) > 0.0
    flat_new = dict(_leaves(new))
    moved = [k for k, old in before.items()
             if not torch.equal(old, flat_new[k])]
    assert all(torch.isfinite(x).all() for _, x in _leaves(new))
    # every leaf took a gradient step (the conv bias and the shared
    # expert included)
    assert len(moved) == len(flat_new), sorted(set(flat_new) - set(moved))


def _leaves(tree, path=""):
    if torch.is_tensor(tree):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{path}/{k}")


def test_shared_expert_at_its_own_width():
    cfg = smoke()
    p = random_params(cfg)
    ffn = p["blocks"]["pos0"]["ffn"]
    assert cfg.shared_width == 96 != cfg.moe.d_expert
    assert tuple(ffn["shared"]["w_gate"].shape) == (1, cfg.d_model, 96)
    assert tuple(ffn["shared"]["w_down"].shape) == (1, 96, cfg.d_model)
    assert tuple(ffn["w_gate"].shape) == (1, cfg.moe.num_experts,
                                          cfg.d_model, cfg.moe.d_expert)
    narrow = dataclasses.replace(cfg, port=dataclasses.replace(
        cfg.port, shared_d_ff=None))
    assert cfg.param_count() - narrow.param_count() == (
        3 * cfg.d_model * (96 - cfg.moe.d_expert) * cfg.n_layers)


def _departed(cfg, p, how):
    sw = cfg.port
    if how == "bf16":
        return dataclasses.replace(cfg, compute_dtype="bfloat16"), p
    if how == "rope":
        return dataclasses.replace(cfg, port=dataclasses.replace(
            sw, rope=True)), p
    if how == "no_conv_bias":
        return dataclasses.replace(cfg, port=dataclasses.replace(
            sw, conv_bias=False)), p
    field = {"no_embed_scale": ("embed_scale", None),
             "no_residual_scale": ("residual_scale", 1.0),
             "no_logits_scaling": ("logits_scaling", 1.0),
             "no_score_scale": ("score_scale", None)}[how]
    return dataclasses.replace(cfg, port=dataclasses.replace(
        sw, **dict([field]))), p


@pytest.mark.parametrize("how", ["bf16", "rope", "no_conv_bias",
                                 "no_embed_scale", "no_residual_scale",
                                 "no_logits_scaling", "no_score_scale"])
def test_a_departure_fails_the_tolerance(how):
    cfg = smoke()
    p, t = random_params(cfg), tokens()
    want = reference(cfg, p).forward_logits(t)
    bad_cfg, bad_p = _departed(cfg, p, how)
    if how == "no_conv_bias":
        bad_p = {**p, "blocks": {
            pos: {**b, "mamba": {k: v for k, v in b["mamba"].items()
                                 if k != "conv_b"}} if "mamba" in b else b
            for pos, b in p["blocks"].items()}}
    got = ma.model_forward_logits(bad_p, bad_cfg, t)
    assert gap(got, want) > 100 * RTOL
