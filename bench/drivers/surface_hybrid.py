"""Driver of the model-accuracy surface on the hybrid Mamba-2 / attention
MoE model (``configs/granite-4.0-h-small.json``).

The traffic, window, end-to-end numbers and check are the surface
driver's (``drivers/surface.py``, loaded here as a module of its own):
one client, no think time, one ``model_accuracy`` call a point, the
window's sampled points kept through ``model_forward_logits``' hook and
judged against the plain reference.  What this file puts in place of what
that module takes for models with attention in every layer: the
reference (``reference/hybrid.py``: the hybrid forward, its crossbar
products in the hook's order and the chain across the Mamba layers), the
parameters (``benchlib/hybrid_weights.py``: the program's ``blocks/pos<i>``
tree of one period), the hold of the program's configuration to the
file's published keys, and the unembed's output read back from the
logits (``site_readings``).
"""
from __future__ import annotations

from benchlib import hybrid_weights
from benchlib.registry import DRIVERS, load_module
from reference import hybrid

surface = load_module(DRIVERS / "surface.py", "bench_driver_surface_of_hybrid")


def program_arch(run):
    """The program's configuration of the file's model, held to the file's
    published keys (a run refuses to start where the two disagree)."""
    from repro_torch.configs import registry

    cfg = registry.get_arch(run.config["program_arch"])
    c = run.config
    L = c["num_hidden_layers"]
    want = dict(
        d_model=c["hidden_size"], n_layers=L,
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_head=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
        vocab=c["vocab_size"], tie_embeddings=c["tie_word_embeddings"],
        compute_dtype=c["precision"]["compute_dtype"],
        param_dtype=c["precision"]["param_dtype"], norm_eps=c["rms_norm_eps"],
        embed_scale=c["embedding_multiplier"],
        residual_scale=c["residual_multiplier"],
        logits_scaling=c["logits_scaling"],
        rope=c["position_embedding_type"] != "nope",
        score_scale=c["attention_multiplier"],
        experts=c["num_local_experts"], top_k=c["num_experts_per_tok"],
        ffn=c["intermediate_size"], shared=c["shared_intermediate_size"],
        d_state=c["mamba_d_state"], headdim=c["mamba_d_head"],
        mamba_heads=c["mamba_n_heads"], d_conv=c["mamba_d_conv"],
        chunk=c["mamba_chunk_size"], conv_bias=c["mamba_conv_bias"],
        pattern=[("attn" if t == "attention" else "mamba", "moe")
                 for t in c["layer_types"][:L]])
    got = {k: getattr(cfg, k, None) for k in want}
    sw = cfg.port
    got.update(
        embed_scale=sw.embed_scale, residual_scale=sw.residual_scale,
        logits_scaling=sw.logits_scaling, rope=sw.rope,
        score_scale=sw.score_scale,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        ffn=cfg.moe.d_expert,
        shared=cfg.shared_width if cfg.moe.shared_expert else None,
        d_state=cfg.ssm.d_state, headdim=cfg.ssm.headdim,
        mamba_heads=cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim,
        d_conv=cfg.ssm.d_conv, chunk=cfg.ssm.chunk,
        conv_bias=sw.conv_bias,
        pattern=[tuple(p) for p in cfg.pattern] * cfg.n_pattern_repeats)
    if got != want:
        raise ValueError(f"the program's {cfg.name} is not the configuration "
                         f"file's: {got} != {want}")
    return cfg


_site_readings = surface.site_readings


def site_readings(run, got: dict) -> dict:
    """The surface driver's ``site_readings``, the unembed's output taken
    as the analog logits times ``logits_scaling`` (the program divides the
    unembed's output by it; 16 is a power of two, so the product is that
    output exactly)."""
    scale = float(run.config["logits_scaling"])
    return _site_readings(run, dict(got, analog={
        k: a * scale for k, a in got["analog"].items()}))


surface.site_readings = site_readings
surface.weights = hybrid_weights
surface.program_arch = program_arch
surface.Arch = hybrid.Arch
surface.Model = hybrid.Model
surface.sites = hybrid.sites
surface.site_weight = hybrid.site_weight

setup = surface.setup
window = surface.window
end_to_end = surface.end_to_end
check = surface.check
control_readings = surface.control_readings
program_readings = surface.program_readings
points = surface.points
