"""Random parameters of the hybrid Mamba-2 / attention MoE model, made on
the device from the run's seed: the tree the program takes
(``blocks/pos<i>/...``, one position per entry of ``layer_types``,
stacked over the repeats of that period), laid out from the configuration
file alone.

Each leaf is one draw on a generator on the device (``weights.generator``,
stream 0), in sorted path order: products N(0, 1/fan_in), the embedding
N(0, 1/d), norm offsets (weights stored as offsets from 1) N(0,
``weights.SMALL_STD``), the router N(0, 1/d); the Mamba-2 block's conv
weight and bias N(0, 1/(3 d_conv)), the variance of PyTorch's default
Conv1d draw U(+-1/sqrt(d_conv)); ``a_log`` = log U[1, 16]; ``dt_bias`` the
inverse softplus of dt log-uniform in [1e-3, 1e-1]; ``d_skip`` 1 (the
published init).  Parameters are float32.
"""
from __future__ import annotations

import math

import torch

from benchlib.weights import SMALL_STD, generator

F32 = torch.float32


def normal(std: float, mean: float = 0.0):
    return ("normal", mean, std)


def leaf_specs(conf: dict) -> dict:
    """{path: (shape, draw)} of every parameter."""
    d = conf["hidden_size"]
    L = conf["num_hidden_layers"]
    types = conf["layer_types"][:L]
    R = L // len(types)
    h = conf["num_attention_heads"]
    kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim", d // h)
    V = conf["vocab_size"]
    E, f = conf["num_local_experts"], conf["intermediate_size"]
    fs = conf["shared_intermediate_size"]
    d_in = conf["mamba_expand"] * d
    H, N, K = conf["mamba_n_heads"], conf["mamba_d_state"], conf["mamba_d_conv"]
    conv_ch = d_in + 2 * N
    spec = {"embed": ((V, d), normal(1.0 / math.sqrt(d))),
            "final_norm": ((d,), normal(SMALL_STD))}
    if not conf["tie_word_embeddings"]:
        spec["unembed"] = ((d, V), normal(1.0 / math.sqrt(d)))
    for i, t in enumerate(types):
        b = f"blocks/pos{i}"
        spec[f"{b}/ln1"] = ((R, d), normal(SMALL_STD))
        spec[f"{b}/ln2"] = ((R, d), normal(SMALL_STD))
        if t == "attention":
            spec.update({
                f"{b}/attn/wq": ((R, d, h * hd), normal(d ** -0.5)),
                f"{b}/attn/wk": ((R, d, kv * hd), normal(d ** -0.5)),
                f"{b}/attn/wv": ((R, d, kv * hd), normal(d ** -0.5)),
                f"{b}/attn/wo": ((R, h * hd, d), normal((h * hd) ** -0.5))})
        else:
            m = f"{b}/mamba"
            spec.update({
                f"{m}/w_z": ((R, d, d_in), normal(d ** -0.5)),
                f"{m}/w_xbc": ((R, d, conv_ch), normal(d ** -0.5)),
                f"{m}/w_dt": ((R, d, H), normal(d ** -0.5)),
                f"{m}/dt_bias": ((R, H), ("dt_bias", 1e-3, 1e-1)),
                f"{m}/a_log": ((R, H), ("log_uniform", 1.0, 16.0)),
                f"{m}/d_skip": ((R, H), ("ones",)),
                f"{m}/conv_w": ((R, K, conv_ch), normal((3 * K) ** -0.5)),
                f"{m}/norm": ((R, d_in), normal(SMALL_STD)),
                f"{m}/w_out": ((R, d_in, d), normal(d_in ** -0.5))})
            if conf["mamba_conv_bias"]:
                spec[f"{m}/conv_b"] = ((R, conv_ch), normal((3 * K) ** -0.5))
        spec.update({
            f"{b}/ffn/router": ((R, d, E), normal(d ** -0.5)),
            f"{b}/ffn/w_gate": ((R, E, d, f), normal(d ** -0.5)),
            f"{b}/ffn/w_up": ((R, E, d, f), normal(d ** -0.5)),
            f"{b}/ffn/w_down": ((R, E, f, d), normal(f ** -0.5)),
            f"{b}/ffn/shared/w_gate": ((R, d, fs), normal(d ** -0.5)),
            f"{b}/ffn/shared/w_up": ((R, d, fs), normal(d ** -0.5)),
            f"{b}/ffn/shared/w_down": ((R, fs, d), normal(fs ** -0.5))})
    return spec


def _draw(t: torch.Tensor, draw: tuple, gen) -> None:
    kind = draw[0]
    if kind == "normal":
        t.normal_(draw[1], draw[2], generator=gen)
    elif kind == "ones":
        t.fill_(1.0)
    elif kind == "log_uniform":
        # log of U[lo, hi]
        t.uniform_(draw[1], draw[2], generator=gen).log_()
    elif kind == "dt_bias":
        # dt log-uniform in [lo, hi], stored as softplus^-1(dt)
        t.uniform_(math.log(draw[1]), math.log(draw[2]), generator=gen)
        dt = t.exp()
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(kind)


def make_params(conf: dict, seed: int, device) -> dict:
    """The parameter tree (nested dicts of float32 tensors on ``device``)."""
    gen = generator(seed, 0, device)
    specs = leaf_specs(conf)
    tree: dict = {}
    for path in sorted(specs):
        shape, draw = specs[path]
        t = torch.empty(shape, device=device, dtype=F32)
        _draw(t, draw, gen)
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree
