"""Operations and bytes of the hybrid Mamba-2 / attention MoE model
(``configs/granite-4.0-h-small.json``), counted from the configuration's
shapes.  ``benchlib/flops.py`` assumes attention in every layer; this file
counts a ``layer_types`` list.

The forward count is 2 x the active parameters in products per token (the
Mamba projections, the attention projections, the routed experts at their
top k, the shared expert, the routers and the unembed) plus the
attention's whole S x S square (4 heads x head dim x S per token and
attention layer) plus, per Mamba layer and token, the state-space dual
form's products: the intra-chunk C B^T (2 Q N) and its weighted sum of the
inputs (2 Q H P) over the whole chunk square, each chunk's state (2 H P N)
and its read-out (2 H P N).  Elementwise work is not counted.  The analog
work is that of ``flops.analog_work`` over the products a crossbar holds:
the attention projections, the shared expert and the unembed.
"""
from __future__ import annotations


def sizes(conf: dict) -> dict:
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    L = conf["num_hidden_layers"]
    types = conf["layer_types"][:L]
    return dict(
        d=d, h=h, kv=conf["num_key_value_heads"],
        hd=conf.get("head_dim", d // h), V=conf["vocab_size"],
        E=conf["num_local_experts"], k=conf["num_experts_per_tok"],
        f=conf["intermediate_size"], fs=conf["shared_intermediate_size"],
        d_in=conf["mamba_expand"] * d, H=conf["mamba_n_heads"],
        P=conf["mamba_d_head"], N=conf["mamba_d_state"],
        Q=conf["mamba_chunk_size"], L=L,
        n_attn=sum(t == "attention" for t in types),
        n_mamba=sum(t == "mamba" for t in types))


def analog_shapes(conf: dict) -> list:
    """(K, N, count) of every product an analog forward routes through
    the crossbar."""
    s = sizes(conf)
    a, L = s["n_attn"], s["L"]
    return [(s["d"], s["h"] * s["hd"], a), (s["d"], s["kv"] * s["hd"], 2 * a),
            (s["h"] * s["hd"], s["d"], a), (s["d"], s["fs"], 2 * L),
            (s["fs"], s["d"], L), (s["d"], s["V"], 1)]


def analog_work(conf: dict, m: int) -> tuple:
    """(operations, bytes) of one analog forward over ``m`` rows: 2 M K N
    multiply-adds plus one conductance rebuild per weight element; x and w
    read once and the output written once (float32)."""
    ops = byt = 0
    for k, n, count in analog_shapes(conf):
        ops += count * (2 * m * k * n + k * n)
        byt += count * 4 * (m * k + k * n + m * n)
    return ops, byt


def matmul_params(conf: dict, active: bool = True) -> int:
    """Parameters in products per token (the embedding lookup excluded,
    the tied unembed counted once; experts at their top k when
    ``active``)."""
    s = sizes(conf)
    d = s["d"]
    conv_ch = s["d_in"] + 2 * s["N"]
    mamba = d * (s["d_in"] + conv_ch + s["H"]) + s["d_in"] * d
    attn = d * s["hd"] * (s["h"] + 2 * s["kv"]) + s["h"] * s["hd"] * d
    e = s["k"] if active else s["E"]
    ffn = e * 3 * d * s["f"] + 3 * d * s["fs"] + d * s["E"]
    return (s["n_mamba"] * mamba + s["n_attn"] * attn + s["L"] * ffn
            + d * s["V"])


def forward_flops(conf: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward of ``batch`` x ``seq`` tokens."""
    s = sizes(conf)
    tokens = batch * seq
    attn = 4 * s["n_attn"] * s["h"] * s["hd"] * seq * tokens
    ssd = s["n_mamba"] * tokens * (2 * s["Q"] * s["N"]
                                   + 2 * s["Q"] * s["H"] * s["P"]
                                   + 4 * s["H"] * s["P"] * s["N"])
    return 2.0 * matmul_params(conf, True) * tokens + attn + ssd
