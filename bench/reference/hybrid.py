"""Plain PyTorch reference of the benchmark's hybrid Mamba-2 / attention
mixture-of-experts model (IBM Granite 4.0-H, HF ``granitemoehybrid``).

Written from the configuration file (``bench/configs/<config>.json``,
the published keys of HF ``GraniteMoeHybridForCausalLM``):

- the embedding times ``embedding_multiplier``;
- per layer (``layer_types``): a pre-norm, the mixer, and the residual
  ``x + y * residual_multiplier``; then a post-norm, the routed experts
  plus the shared SwiGLU expert, and the same scaled residual.  The mixer
  is a Mamba-2 block (in-projections to z, [x, B, C] and dt; a causal
  depthwise conv with bias and SiLU; the chunked state-space dual form
  with one group; the D skip; the gated RMSNorm, ``y * silu(z)`` before
  the norm; the out-projection) or grouped-query attention with no
  position embedding, scores times ``attention_multiplier``;
- the final RMSNorm, the tied unembed, the logits divided by
  ``logits_scaling``.

Norm weights are stored as offsets from 1.  Parameters are float32 and
every product runs in its input's dtype (the compute dtype, or float32
once a float32 crossbar output has entered the residual stream), the
state-space scan in float32, as the program runs them.  The routed experts
follow ``reference.model``'s mixture: softmax over all experts, the top k
renormalised (equal to the published softmax over the top-k logits up to
rounding) and capacity dispatch in groups, where the published model is
dropless: the program's departure, stated in the configuration file.

``linear_hook(x2d, w, tag)`` replaces every product a crossbar holds: the
attention projections ``wq`` ``wk`` ``wv`` ``wo``, the shared expert's
``w_gate`` ``w_up`` ``w_down`` and the ``unembed``.  The Mamba
projections, routers and routed experts stay exact.  ``forward_logits``
runs the full sequence at once; ``teacher_forced`` follows a forward layer
by layer from another forward's crossbar inputs and outputs, computing
each Mamba layer whole between them; ``sites`` lists the crossbar
products in the order a forward reaches them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import model as base
from reference.model import ATTN_TAGS, FFN_TAGS, rms_norm, row_gaps

F32 = torch.float32


class Arch(base.Arch):
    """The sizes and switches of one hybrid configuration file."""

    def __init__(self, conf: dict):
        self.d = conf["hidden_size"]
        self.n_layers = conf["num_hidden_layers"]
        self.layer_types = list(conf["layer_types"][:self.n_layers])
        self.period = len(self.layer_types)
        self.attn_layers = [i for i, t in enumerate(self.layer_types)
                            if t == "attention"]
        self.heads = conf["num_attention_heads"]
        self.kv_heads = conf["num_key_value_heads"]
        self.head_dim = conf.get("head_dim", self.d // self.heads)
        self.tied = conf["tie_word_embeddings"]
        self.eps = float(conf["rms_norm_eps"])
        self.dtype = base.DTYPES[conf["precision"]["compute_dtype"]]
        self.score_scale = float(conf["attention_multiplier"])
        self.embed_scale = float(conf["embedding_multiplier"])
        self.residual_scale = float(conf["residual_multiplier"])
        self.logits_scaling = float(conf["logits_scaling"])
        assert conf["position_embedding_type"] == "nope"
        self.m_heads = conf["mamba_n_heads"]
        self.m_head_dim = conf["mamba_d_head"]
        self.m_state = conf["mamba_d_state"]
        self.m_conv = conf["mamba_d_conv"]
        self.m_chunk = conf["mamba_chunk_size"]
        self.m_inner = conf["mamba_expand"] * self.d
        assert conf["mamba_n_groups"] == 1
        assert self.m_heads * self.m_head_dim == self.m_inner
        self.conv_bias = conf["mamba_conv_bias"]
        self.experts = conf["num_local_experts"]
        moe = conf["routing"]
        self.top_k = conf["num_experts_per_tok"]
        self.group = moe["group_tokens"]
        self.capacity_factor = moe["capacity_factor"]
        self.dropless_group = moe["dropless_up_to_tokens"]
        self.min_capacity = moe["min_capacity"]

    def where(self, layer: int) -> tuple:
        """(pattern position, repeat) of a layer in the program's tree."""
        return layer % self.period, layer // self.period


def sites(arch: Arch) -> list:
    """Every crossbar product of a forward as (tag, k), the k-th call with
    the tag, in the order the forward reaches them: per layer the
    attention's four (k counts attention layers) where the layer has
    attention, then the shared expert's three (k the layer); the unembed
    last, as (``unembed``, 0)."""
    out = []
    for i, t in enumerate(arch.layer_types):
        if t == "attention":
            out += [(tag, arch.attn_layers.index(i)) for tag in ATTN_TAGS]
        out += [(tag, i) for tag in FFN_TAGS]
    return out + [("unembed", 0)]


def site_weight(arch: Arch, params: dict, site: tuple) -> torch.Tensor:
    """The weight of crossbar product ``site`` = (tag, k)."""
    tag, k = site
    if tag == "unembed":
        return params["embed"].T if arch.tied else params["unembed"]
    if tag in ATTN_TAGS:
        pos, rep = arch.where(arch.attn_layers[k])
        return params["blocks"][f"pos{pos}"]["attn"][tag][rep]
    pos, rep = arch.where(k)
    return params["blocks"][f"pos{pos}"]["ffn"]["shared"][tag][rep]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): sum of a[j+1..i] at (i, j) for i >= j,
    -inf above the diagonal."""
    Q = a.shape[-1]
    rep = a[..., None].expand(*a.shape, Q)                       # (..., i, j)
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device),
                       diagonal=-1)
    s = torch.cumsum(rep.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """The chunked state-space dual form (Mamba-2, one group), float32:
    x (B, L, H, P), dt (B, L, H), A (H,), B and C (B, L, N) -> y (B, L, H,
    P), the state starting at zero.  L a multiple of ``chunk``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    c = L // chunk
    X = (x * dt[..., None]).reshape(Bsz, c, chunk, H, P)
    Adt = (A * dt).reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)  # b h c l
    Bc = Bm.reshape(Bsz, c, chunk, N)
    Cc = Cm.reshape(Bsz, c, chunk, N)
    a_cum = torch.cumsum(Adt, dim=-1)
    # 1. within each chunk
    Lmat = torch.exp(segsum(Adt))                                 # b h c l s
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    W = CB[:, None] * Lmat                                        # b h c l s
    y_diag = torch.einsum("bhcls,bcshp->bclhp", W, X)
    del Lmat, W
    # 2. each chunk's state from its own inputs
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)             # b h c l
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, X)
    # 3. the states passed from chunk to chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each state read out at the positions of the next chunk
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(Bsz, L, H, P)


class Model(base.Model):
    # -- the Mamba-2 mixer ------------------------------------------------
    def mamba(self, mp, h):
        a = self.a
        Bsz, L, _ = h.shape
        dt_ = h.dtype
        H, P, N, K = a.m_heads, a.m_head_dim, a.m_state, a.m_conv
        z = self.prec.mm(h, mp["w_z"].to(dt_))
        xbc = self.prec.mm(h, mp["w_xbc"].to(dt_))
        # causal depthwise conv: the tap of position t - i for i = 0..K-1,
        # newest first, then the bias
        w = mp["conv_w"].to(dt_)
        conv = xbc * w[K - 1]
        for i in range(1, K):
            conv = conv + F.pad(xbc, (0, 0, i, 0))[:, :L] * w[K - 1 - i]
        if a.conv_bias:
            conv = conv + mp["conv_b"].to(dt_)
        xbc = F.silu(conv)
        xs, Bs, Cs = torch.split(xbc, [a.m_inner, N, N], dim=-1)
        dt = F.softplus(self.prec.mm(h, mp["w_dt"].to(dt_)).to(F32)
                        + mp["dt_bias"].to(F32), threshold=1e30)
        A = -torch.exp(mp["a_log"].to(F32))
        pad = (-L) % a.m_chunk

        def padded(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

        x4 = xs.to(F32).reshape(Bsz, L, H, P)
        y = ssd(padded(x4), padded(dt), A, padded(Bs.to(F32)),
                padded(Cs.to(F32)), a.m_chunk)[:, :L]
        y = y + mp["d_skip"].to(F32)[:, None] * x4
        y = y.reshape(Bsz, L, a.m_inner).to(dt_) * F.silu(z)
        y = rms_norm(y, mp["norm"], a.eps)
        return self.prec.mm(y, mp["w_out"].to(dt_))

    # -- attention with no position embedding ------------------------------
    def attention_core(self, lp, q, k, v, q_block: int, in_dtype):
        a = self.a
        B, S, _ = q.shape
        q = q.reshape(B, S, a.heads, a.head_dim)
        k = k.reshape(B, S, a.kv_heads, a.head_dim)
        v = v.reshape(B, S, a.kv_heads, a.head_dim)
        rep = a.heads // a.kv_heads
        qh = q.permute(0, 2, 1, 3)
        kh = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
        outs = []
        for s0 in range(0, S, q_block):
            s1 = min(S, s0 + q_block)
            sc = self.prec.mm(qh[:, :, s0:s1], kh[..., :s1]).to(F32) \
                * a.score_scale
            qi = torch.arange(s0, s1, device=q.device)[:, None]
            ki = torch.arange(s1, device=q.device)[None, :]
            sc = sc.masked_fill(ki > qi, float("-inf"))
            pr = torch.softmax(sc, dim=-1).to(q.dtype)
            outs.append(self.prec.mm(pr, vh[:, :, :s1]))
        return torch.cat(outs, dim=2).permute(0, 2, 1, 3).reshape(
            B, S, a.heads * a.head_dim)

    # -- blocks -------------------------------------------------------------
    def residual(self, x, y):
        return x + y * self.a.residual_scale

    def ffn(self, fp, h):
        return self.moe_ffn(fp, h) + self.dense_ffn(fp["shared"], h)

    def block(self, lp, x, q_block: int, layer: int = 0):
        a = self.a
        h = rms_norm(x, lp["ln1"], a.eps)
        if a.layer_types[layer] == "attention":
            y = self.attention(lp, h, q_block)
        else:
            y = self.mamba(lp["mamba"], h)
        x = self.residual(x, y)
        return self.residual(x, self.ffn(lp["ffn"], rms_norm(x, lp["ln2"],
                                                             a.eps)))

    def layer_params(self, i: int):
        pos, rep = self.a.where(i)

        def take(t):
            return t[rep] if torch.is_tensor(t) else {k: take(v)
                                                      for k, v in t.items()}
        return take(self.p["blocks"][f"pos{pos}"])

    def embed(self, tokens):
        dt = self.a.dtype
        scale = torch.tensor(self.a.embed_scale, dtype=F32,
                             device=tokens.device).to(dt)
        return self.p["embed"][tokens].to(dt) * scale

    def logits(self, x):
        x = rms_norm(x, self.p["final_norm"], self.a.eps)
        out = self.linear(x, self.unembed_matrix(), "unembed").to(F32)
        return out / self.a.logits_scaling

    # -- entry points -------------------------------------------------------
    def forward_logits(self, tokens, q_block: int = 1024):
        """(B, S) tokens -> (B, S, vocab) float32 logits."""
        with torch.no_grad():
            x = self.embed(tokens)
            for i in range(self.a.n_layers):
                x = self.block(self.layer_params(i), x, q_block, i)
            return self.logits(x)

    def teacher_forced(self, tokens, sites: dict, rows: torch.Tensor,
                       q_block: int = 1024) -> list:
        """``reference.model.Model.teacher_forced`` for the hybrid: the
        residual stream is this model's own, every crossbar output added
        to it is the other forward's, and everything between two crossbars
        is computed here: norms, each Mamba layer whole, the attention's
        core, the shared expert's gate and the routed experts.  Returns
        [(what, layer, row gaps at ``rows``)] of each crossbar input the
        other forward took against the one computed here."""
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
                if a.layer_types[i] == "attention":
                    k = a.attn_layers.index(i)
                    out.append(("attn_in", i, row_gaps(
                        at_rows(h), at_rows(sites[("wq", k)]["x"]))))
                    o = self.attention_core(
                        lp, full(("wq", k)), full(("wk", k)),
                        full(("wv", k)), q_block,
                        sites[("wq", k)]["x"].dtype)
                    out.append(("attn_core", i, row_gaps(
                        at_rows(o), at_rows(sites[("wo", k)]["x"]))))
                    x = self.residual(x, full(("wo", k)))
                else:
                    x = self.residual(x, self.mamba(lp["mamba"], h))
                h = rms_norm(x, lp["ln2"], a.eps)
                out.append(("ffn_in", i, row_gaps(
                    at_rows(h), at_rows(sites[("w_gate", i)]["x"]))))
                m = F.silu(y_of(("w_gate", i))) * y_of(("w_up", i))
                out.append(("ffn_mid", i, row_gaps(
                    m, at_rows(sites[("w_down", i)]["x"]))))
                x = self.residual(x, self.moe_ffn(lp["ffn"], h)
                                  + full(("w_down", i)))
            x = rms_norm(x, self.p["final_norm"], a.eps)
            out.append(("unembed_in", a.n_layers, row_gaps(
                at_rows(x), at_rows(sites[("unembed", 0)]["x"]))))
        return out

