"""Plain PyTorch reference of the benchmark's decoder-only models.

Written from the configuration file (``bench/configs/<config>.json``):
pre-norm blocks of grouped-query attention (optional QKV bias, optional
per-head q/k RMSNorm, rotary embeddings) and a SwiGLU FFN or a routed
mixture of experts, a final RMSNorm and the (tied or separate) unembed.
Norm weights are stored as offsets from 1.  Parameters are float32 and
every product runs in the compute dtype (``precision.compute_dtype``):
each weight is cast to its input's dtype first, as the configuration
states, so a float32 input makes a float32 product.

The mixture of experts routes each group of ``group_tokens`` tokens: a
float32 router, softmax, the top k experts (ties to the lower index), the
k gates renormalised to sum to 1, and at most ``capacity`` (token, choice)
pairs per expert kept in (token, choice) order; the rest are dropped.

``linear_hook(x2d, w, tag)`` replaces every product that a crossbar holds
(the attention projections ``wq`` ``wk`` ``wv`` ``wo``, the dense FFN's
``w_gate`` ``w_up`` ``w_down`` and the ``unembed``, the tag naming it);
routers and experts stay exact.  ``forward_logits`` runs the full
sequence at once (no autograd); ``teacher_forced`` follows one forward
layer by layer from another forward's crossbar inputs and outputs;
``train_loss`` recomputes each layer in the backward and runs attention
and the loss in blocks of positions, so a full-size step fits beside
nothing else on one card.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.precision import Precision

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Arch:
    """The sizes and switches of one configuration file."""

    def __init__(self, conf: dict):
        self.d = conf["hidden_size"]
        self.n_layers = conf["num_hidden_layers"]
        self.heads = conf["num_attention_heads"]
        self.kv_heads = conf["num_key_value_heads"]
        self.head_dim = conf.get("head_dim", self.d // self.heads)
        self.ff = conf["intermediate_size"]
        self.vocab = conf["vocab_size"]
        self.tied = conf["tie_word_embeddings"]
        self.qkv_bias = conf.get("qkv_bias", False)
        self.qk_norm = conf.get("qk_norm", False)
        self.rope_theta = float(conf["rope_theta"])
        self.eps = float(conf["rms_norm_eps"])
        self.dtype = DTYPES[conf["precision"]["compute_dtype"]]
        self.experts = conf.get("num_experts", 0)
        if self.experts:
            moe = conf["routing"]
            self.top_k = conf["num_experts_per_tok"]
            self.group = moe["group_tokens"]
            self.capacity_factor = moe["capacity_factor"]
            self.dropless_group = moe["dropless_up_to_tokens"]
            self.min_capacity = moe["min_capacity"]

    def capacity(self, tokens_per_group: int) -> int:
        if tokens_per_group <= self.dropless_group:
            return tokens_per_group * self.top_k
        return max(self.min_capacity, int(tokens_per_group * self.top_k
                                          * self.capacity_factor
                                          / self.experts))


def rms_norm(x, offset, eps):
    dt = x.dtype
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + offset.to(F32))).to(dt)


def rope(x, theta):
    """x (B, S, H, D) rotated by its position along S (half-split pairs)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device)
                          / float(half)))
    ang = torch.arange(S, device=x.device).to(F32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xf = x.to(F32)
    a, b = xf[..., :half], xf[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)


ATTN_TAGS = ("wq", "wk", "wv", "wo")
FFN_TAGS = ("w_gate", "w_up", "w_down")


def sites(arch: Arch) -> list:
    """Every crossbar product of a forward as (tag, layer), in the order
    the forward reaches them; the unembed is (``unembed``, 0)."""
    tags = ATTN_TAGS + (() if arch.experts else FFN_TAGS)
    return [(t, l) for l in range(arch.n_layers) for t in tags] + [
        ("unembed", 0)]


def site_weight(arch: Arch, params: dict, site: tuple) -> torch.Tensor:
    """The weight of crossbar product ``site`` = (tag, layer)."""
    tag, layer = site
    if tag == "unembed":
        return params["embed"].T if arch.tied else params["unembed"]
    group = "attn" if tag in ATTN_TAGS else "ffn"
    return params["blocks"]["pos0"][group][tag][layer]


def row_gaps(ref: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """|ref - got| / |ref| of each row (float32), the last axis the row."""
    r = ref.reshape(-1, ref.shape[-1]).to(F32)
    g = got.reshape(r.shape).to(F32)
    return (torch.linalg.vector_norm(r - g, dim=-1)
            / torch.clamp_min(torch.linalg.vector_norm(r, dim=-1), 1e-30))


class Model:
    def __init__(self, arch: Arch, params: dict, prec: Precision,
                 linear_hook: Optional[Callable] = None):
        self.a = arch
        self.p = params
        self.prec = prec
        self.hook = linear_hook

    # -- products ---------------------------------------------------------
    def linear(self, x, w, tag: str = ""):
        w = w.to(x.dtype)
        if self.hook is None:
            return self.prec.mm(x, w)
        y = self.hook(x.reshape(-1, x.shape[-1]), w, tag)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    # -- blocks -----------------------------------------------------------
    def attention(self, lp, h, q_block: int):
        q, k, v = (self.linear(h, lp["attn"][t], t)
                   for t in ("wq", "wk", "wv"))
        return self.linear(self.attention_core(lp, q, k, v, q_block, h.dtype),
                           lp["attn"]["wo"], "wo")

    def attention_core(self, lp, q, k, v, q_block: int, in_dtype):
        """(B, S, *) projections (before their bias; ``in_dtype`` their
        input's dtype, which the bias takes) -> (B, S, heads x head_dim),
        the input of ``wo``."""
        a = self.a
        B, S, _ = q.shape
        if a.qkv_bias:
            q = q + lp["attn"]["bq"].to(in_dtype)
            k = k + lp["attn"]["bk"].to(in_dtype)
            v = v + lp["attn"]["bv"].to(in_dtype)
        q = q.reshape(B, S, a.heads, a.head_dim)
        k = k.reshape(B, S, a.kv_heads, a.head_dim)
        v = v.reshape(B, S, a.kv_heads, a.head_dim)
        if a.qk_norm:
            q = rms_norm(q, lp["attn"]["q_norm"], a.eps)
            k = rms_norm(k, lp["attn"]["k_norm"], a.eps)
        q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
        rep = a.heads // a.kv_heads
        qh = q.permute(0, 2, 1, 3)                               # B H S D
        kh = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)  # B H D S
        vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)  # B H S D
        scale = torch.tensor(math.sqrt(a.head_dim), dtype=F32, device=q.device)
        outs = []
        for s0 in range(0, S, q_block):
            s1 = min(S, s0 + q_block)
            sc = self.prec.mm(qh[:, :, s0:s1], kh[..., :s1]).to(F32) / scale
            qi = torch.arange(s0, s1, device=q.device)[:, None]
            ki = torch.arange(s1, device=q.device)[None, :]
            sc = sc.masked_fill(ki > qi, float("-inf"))
            pr = torch.softmax(sc, dim=-1).to(q.dtype)
            outs.append(self.prec.mm(pr, vh[:, :, :s1]))
        return torch.cat(outs, dim=2).permute(0, 2, 1, 3).reshape(
            B, S, a.heads * a.head_dim)

    def dense_ffn(self, fp, h):
        g = F.silu(self.linear(h, fp["w_gate"], "w_gate"))
        u = self.linear(h, fp["w_up"], "w_up")
        return self.linear(g * u, fp["w_down"], "w_down")

    def moe_ffn(self, fp, h):
        a = self.a
        B, S, d = h.shape
        n = B * S
        tg = min(a.group, n)
        groups = n // tg
        cap = a.capacity(tg)
        x = h.reshape(n, d)
        probs = torch.softmax(self.prec.mm(x.to(F32), fp["router"].to(F32)),
                              dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = vals[:, :a.top_k]
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        choice = idx[:, :a.top_k]                               # (n, k)
        # rank of each (token, choice) among its expert's pairs, in
        # (token, choice) order within its group
        rank = torch.empty_like(choice)
        for g in range(groups):
            e = choice[g * tg:(g + 1) * tg].reshape(-1)
            order = torch.sort(e, stable=True).indices
            se = e[order]
            first = torch.searchsorted(se, se, right=False)
            r = torch.empty_like(e)
            r[order] = torch.arange(e.numel(), device=e.device) - first
            rank[g * tg:(g + 1) * tg] = r.reshape(tg, a.top_k)
        kept = rank < cap
        gates = (gates * kept).to(h.dtype)
        out = torch.zeros((n, d), dtype=F32, device=h.device)
        tok = torch.arange(n, device=h.device)[:, None].expand_as(choice)
        for e in range(a.experts):
            sel = (choice == e) & kept
            if not bool(sel.any()):
                continue
            t = tok[sel]
            xe = x[t]
            wg, wu, wd = (fp[w][e].to(h.dtype) for w in
                          ("w_gate", "w_up", "w_down"))
            ye = self.prec.mm(F.silu(self.prec.mm(xe, wg))
                              * self.prec.mm(xe, wu), wd)
            out.index_add_(0, t, gates[sel][:, None].to(F32) * ye.to(F32))
        return out.to(h.dtype).reshape(B, S, d)

    def block(self, lp, x, q_block: int):
        a = self.a
        h = rms_norm(x, lp["ln1"], a.eps)
        x = x + self.attention(lp, h, q_block)
        h = rms_norm(x, lp["ln2"], a.eps)
        y = self.moe_ffn(lp["ffn"], h) if a.experts else self.dense_ffn(
            lp["ffn"], h)
        return x + y

    def layer_params(self, i: int):
        def take(t):
            return t[i] if torch.is_tensor(t) else {k: take(v)
                                                    for k, v in t.items()}
        return take(self.p["blocks"]["pos0"])

    def embed(self, tokens):
        dt = self.a.dtype
        scale = torch.sqrt(torch.tensor(float(self.a.d), dtype=F32,
                                        device=tokens.device)).to(dt)
        return self.p["embed"][tokens].to(dt) * scale

    def unembed_matrix(self):
        return self.p["embed"].T if self.a.tied else self.p["unembed"]

    # -- entry points -----------------------------------------------------
    def forward_logits(self, tokens, q_block: int = 1024):
        """(B, S) tokens -> (B, S, vocab) float32 logits."""
        with torch.no_grad():
            x = self.embed(tokens)
            for i in range(self.a.n_layers):
                x = self.block(self.layer_params(i), x, q_block)
            x = rms_norm(x, self.p["final_norm"], self.a.eps)
            return self.linear(x, self.unembed_matrix(), "unembed").to(F32)

    def teacher_forced(self, tokens, sites: dict, rows: torch.Tensor,
                       q_block: int = 1024) -> list:
        """Follow a forward layer by layer from another forward's crossbar
        products ``sites`` {(tag, layer): {"x": (M, K) input, "y": (M, N)
        output, or its ``rows`` where "rows" is set}}: the residual stream
        is this model's own, every crossbar output added to it is the
        other forward's, and everything between two crossbars (norms, the
        attention's core, the FFN's gate and, for a mixture of experts,
        the whole FFN) is computed here.  Returns [(what, layer, row gaps
        at ``rows``)] of each crossbar input the other forward took
        against the one computed here."""
        a = self.a
        B, S = tokens.shape
        out = []

        def at_rows(t):
            return t.reshape(-1, t.shape[-1])[rows]

        def y_of(site):
            got = sites[site]
            return got["y"] if got["rows"] else at_rows(got["y"])

        def full(site):
            got = sites[site]
            assert not got["rows"], site
            return got["y"].reshape(B, S, -1)

        with torch.no_grad():
            x = self.embed(tokens)
            for i in range(a.n_layers):
                lp = self.layer_params(i)
                h = rms_norm(x, lp["ln1"], a.eps)
                out.append(("attn_in", i, row_gaps(
                    at_rows(h), at_rows(sites[("wq", i)]["x"]))))
                o = self.attention_core(
                    lp, full(("wq", i)), full(("wk", i)), full(("wv", i)),
                    q_block, sites[("wq", i)]["x"].dtype)
                out.append(("attn_core", i, row_gaps(
                    at_rows(o), at_rows(sites[("wo", i)]["x"]))))
                x = x + full(("wo", i))
                h = rms_norm(x, lp["ln2"], a.eps)
                if a.experts:
                    x = x + self.moe_ffn(lp["ffn"], h)
                    continue
                out.append(("ffn_in", i, row_gaps(
                    at_rows(h), at_rows(sites[("w_gate", i)]["x"]))))
                m = F.silu(y_of(("w_gate", i))) * y_of(("w_up", i))
                out.append(("ffn_mid", i, row_gaps(
                    m, at_rows(sites[("w_down", i)]["x"]))))
                x = x + full(("w_down", i))
            x = rms_norm(x, self.p["final_norm"], a.eps)
            out.append(("unembed_in", a.n_layers, row_gaps(
                at_rows(x), at_rows(sites[("unembed", 0)]["x"]))))
        return out

    def train_loss(self, tokens, labels, q_block: int = 512,
                   loss_block: int = 1024):
        """Mean next-token cross-entropy of (B, S) tokens against labels,
        with autograd; each layer and each block of the loss recomputed in
        the backward."""
        assert not self.a.experts, "the MoE aux loss is not modelled"
        x = self.embed(tokens)
        for i in range(self.a.n_layers):
            x = checkpoint(lambda x, lp: self.block(lp, x, q_block), x,
                           self.layer_params(i), use_reentrant=False)
        x = rms_norm(x, self.p["final_norm"], self.a.eps)
        w = self.unembed_matrix()

        def block_ce(xb, lb):
            logits = self.linear(xb, w).to(F32)
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   lb.reshape(-1), reduction="sum")

        total = x.new_zeros((), dtype=F32)
        S = x.shape[1]
        for s0 in range(0, S, loss_block):
            total = total + checkpoint(block_ce, x[:, s0:s0 + loss_block],
                                       labels[:, s0:s0 + loss_block],
                                       use_reentrant=False)
        return total / labels.numel()
