"""Operations and bytes counted from shapes, and the card's peaks.

Frozen here so that the yardstick does not move with the program: the
training count is ``chip_smoke.train_flops`` (6 N T for the matmuls, the
tied embedding once as the unembed, plus 12 L (heads x head dim) S T for
the attention's whole S x S score matrix), the forward count is a third of
it with the expert products at their top k, and the analog product's work
is 2 M K N multiply-adds plus one conductance rebuild per weight element,
reading x and w once and writing the output once (float32).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, 700 W
H100_BF16_DENSE_FLOPS = 989e12
H100_FP32_SIMT_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12


def _sizes(conf: dict):
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim", d // h)
    return d, h, kv, hd, conf["intermediate_size"], conf["vocab_size"]


def analog_shapes(conf: dict) -> list:
    """(K, N, count) of every product an analog forward routes through
    the crossbar: the attention projections, the dense FFN and the
    unembed (experts and routers stay exact)."""
    d, h, kv, hd, f, V = _sizes(conf)
    L = conf["num_hidden_layers"]
    shapes = [(d, h * hd, L), (d, kv * hd, 2 * L), (h * hd, d, L)]
    if not conf.get("num_experts"):
        shapes += [(d, f, 2 * L), (f, d, L)]
    shapes.append((d, V, 1))
    return shapes


def analog_work(conf: dict, m: int) -> tuple:
    """(operations, bytes) of one analog forward over ``m`` rows."""
    ops = byt = 0
    for k, n, count in analog_shapes(conf):
        ops += count * (2 * m * k * n + k * n)
        byt += count * 4 * (m * k + k * n + m * n)
    return ops, byt


def least_seconds(ops: float, n_bytes: float, peak: float) -> float:
    return max(ops / peak, n_bytes / H100_HBM_BYTES_S)


def matmul_params(conf: dict, active: bool) -> int:
    """Parameters in products per token (embedding lookup excluded, the
    unembed counted once; experts at their top k when ``active``)."""
    d, h, kv, hd, f, V = _sizes(conf)
    L = conf["num_hidden_layers"]
    per_layer = d * hd * (h + 2 * kv) + h * hd * d
    if conf.get("num_experts"):
        e = conf["num_experts_per_tok"] if active else conf["num_experts"]
        per_layer += e * 3 * d * f + d * conf["num_experts"]
    else:
        per_layer += 3 * d * f
    return L * per_layer + d * V


def forward_flops(conf: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward: 2 N_active per token plus the attention's
    4 L (heads x head dim) S per token (scores and values, the whole
    square)."""
    d, h, kv, hd, f, V = _sizes(conf)
    tokens = batch * seq
    attn = 4 * conf["num_hidden_layers"] * h * hd * seq * tokens
    return 2.0 * matmul_params(conf, active=True) * tokens + attn


def train_flops(conf: dict, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (``chip_smoke.train_flops``)."""
    d, h, kv, hd, f, V = _sizes(conf)
    tokens = batch * seq
    attn = 12 * conf["num_hidden_layers"] * h * hd * seq * tokens
    return 6.0 * n_params * tokens + attn
