"""Random parameters and tokens of a configuration, made on the device from
the run's seed.

The tree is the one the program takes (``blocks/pos0/<site>`` stacked over
the layers, as ``repro_torch.models.model`` names them) and is laid out
here from the configuration file alone.  Each leaf is one
``normal_`` draw (one per layer past 2**30 elements) on a generator on the
device: products
N(0, 1/fan_in) with fan_in the product's input width, the embedding
N(0, 1/d), norm offsets (weights stored as offsets from 1) and biases
N(0, ``small_std``), the router N(0, 1/d).  Parameters are float32, the
type the program serves them in.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
SMALL_STD = 0.02


def leaf_specs(conf: dict) -> dict:
    """{path: (shape, std)} of every parameter."""
    d = conf["hidden_size"]
    L = conf["num_hidden_layers"]
    h = conf["num_attention_heads"]
    kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim", d // h)
    V = conf["vocab_size"]
    spec = {
        "embed": ((V, d), 1.0 / math.sqrt(d)),
        "final_norm": ((d,), SMALL_STD),
        "blocks/pos0/ln1": ((L, d), SMALL_STD),
        "blocks/pos0/ln2": ((L, d), SMALL_STD),
        "blocks/pos0/attn/wq": ((L, d, h * hd), 1.0 / math.sqrt(d)),
        "blocks/pos0/attn/wk": ((L, d, kv * hd), 1.0 / math.sqrt(d)),
        "blocks/pos0/attn/wv": ((L, d, kv * hd), 1.0 / math.sqrt(d)),
        "blocks/pos0/attn/wo": ((L, h * hd, d), 1.0 / math.sqrt(h * hd)),
    }
    if not conf["tie_word_embeddings"]:
        spec["unembed"] = ((d, V), 1.0 / math.sqrt(d))
    if conf.get("qkv_bias"):
        spec["blocks/pos0/attn/bq"] = ((L, h * hd), SMALL_STD)
        spec["blocks/pos0/attn/bk"] = ((L, kv * hd), SMALL_STD)
        spec["blocks/pos0/attn/bv"] = ((L, kv * hd), SMALL_STD)
    if conf.get("qk_norm"):
        spec["blocks/pos0/attn/q_norm"] = ((L, hd), SMALL_STD)
        spec["blocks/pos0/attn/k_norm"] = ((L, hd), SMALL_STD)
    if conf.get("num_experts"):
        E, f = conf["num_experts"], conf["intermediate_size"]
        spec["blocks/pos0/ffn/router"] = ((L, d, E), 1.0 / math.sqrt(d))
        spec["blocks/pos0/ffn/w_gate"] = ((L, E, d, f), 1.0 / math.sqrt(d))
        spec["blocks/pos0/ffn/w_up"] = ((L, E, d, f), 1.0 / math.sqrt(d))
        spec["blocks/pos0/ffn/w_down"] = ((L, E, f, d), 1.0 / math.sqrt(f))
    else:
        f = conf["intermediate_size"]
        spec["blocks/pos0/ffn/w_gate"] = ((L, d, f), 1.0 / math.sqrt(d))
        spec["blocks/pos0/ffn/w_up"] = ((L, d, f), 1.0 / math.sqrt(d))
        spec["blocks/pos0/ffn/w_down"] = ((L, f, d), 1.0 / math.sqrt(f))
    return spec


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream (weights 0, tokens 1, ...)
    of the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2 ** 63)


def make_params(conf: dict, seed: int, device) -> dict:
    """The parameter tree (nested dicts of float32 tensors on ``device``)."""
    gen = generator(seed, 0, device)
    tree: dict = {}
    for path in sorted(leaf_specs(conf)):
        shape, std = leaf_specs(conf)[path]
        t = torch.empty(shape, device=device, dtype=F32)
        # leaves past 2**30 elements are drawn one layer at a time
        for part in [t] if t.numel() <= 2 ** 30 else list(t):
            part.normal_(0.0, std, generator=gen)
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree

