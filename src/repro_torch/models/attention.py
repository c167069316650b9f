"""Grouped-query attention (port of ``repro.models.attention``): QKV
projections (with bias, per-head q/k RMSNorm, RoPE unless ``port.rope`` is
off), scores over sqrt(head dim) or times ``port.score_scale``, the
materialized-score path and the chunked online-softmax path over a full
sequence (only the (query block, key chunk) tiles its mask leaves live),
bidirectional encoder attention, decoder cross-attention over precomputed
encoder K/V, single-token decode against a preallocated KV cache, and the
output projection.

The arithmetic mirrors the reference's jnp step by step (einsums, float32
scores, additive -1e30 mask, softmax cast back to the compute dtype), so
the port compares with it operation by operation; it deliberately does
not call a fused attention operator.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch

from repro_torch._span import span
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (ParamSpec, apply_rope, linear, rms_norm,
                                       softcap)
from repro_torch.models.sharding_hooks import constrain

_F32 = torch.float32
# above this query length the chunked (flash-style) path is used
CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024
# the profiler span, one a computed (query block, key chunk) tile
TILE_SPAN = "repro.attn.tile"


def attn_specs(cfg: ArchConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    sp = {
        "wq": ParamSpec((d, h * hd), ("embed", "q_proj")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_proj")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_proj")),
        "wo": ParamSpec((h * hd, d), ("q_proj", "embed")),
    }
    if cfg.attn.qkv_bias and not cross:
        sp["bq"] = ParamSpec((h * hd,), ("q_proj",), "zeros")
        sp["bk"] = ParamSpec((kv * hd,), ("kv_proj",), "zeros")
        sp["bv"] = ParamSpec((kv * hd,), ("kv_proj",), "zeros")
    if cfg.attn.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), (None,), "zeros")
        sp["k_norm"] = ParamSpec((hd,), (None,), "zeros")
    return sp


def _project_qkv(p, x, cfg: ArchConfig, positions, rope: bool = True):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(x, p["wq"].to(x.dtype), "wq")
    k = linear(x, p["wk"].to(x.dtype), "wk")
    v = linear(x, p["wv"].to(x.dtype), "wv")
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.attn.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope and cfg.port.rope:
        q = apply_rope(q, positions, cfg.attn.rope_theta,
                       cfg.attn.mrope_sections)
        k = apply_rope(k, positions, cfg.attn.rope_theta,
                       cfg.attn.mrope_sections)
    return q, k, v


def _merge_heads(p, o, cfg: ArchConfig):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.d_head)
    return linear(o, p["wo"].to(o.dtype), "wo")


def _mask_full(S: int, Skv: int, causal: bool, window: Optional[int],
               offset: int = 0, device=None) -> torch.Tensor:
    """(S, Skv) additive float32 mask; ``offset`` = index of query 0 in the
    kv timeline."""
    qi = torch.arange(S, device=device)[:, None] + offset
    ki = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    zero = torch.zeros((), dtype=_F32, device=device)
    return torch.where(ok, zero, zero - 1e30)


def _sqrt_hd(hd: int, device) -> torch.Tensor:
    """sqrt(hd) as a 0-dim float32 tensor on ``device`` (a host copy)."""
    return torch.tensor(math.sqrt(hd), dtype=_F32, device=device)


def _scale_scores(s: torch.Tensor, hd: int, cfg: ArchConfig,
                  div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores over sqrt(hd), or times ``cfg.port.score_scale`` where set
    (granite's ``attention_multiplier``).  ``div``: sqrt(hd) from
    ``_sqrt_hd``, built here where not given."""
    if cfg.port.score_scale is not None:
        return s * cfg.port.score_scale
    return s / (_sqrt_hd(hd, s.device) if div is None else div)


def full_attention(q, k, v, cfg: ArchConfig, causal: bool, window,
                   offset: int = 0):
    """Materialized-scores path (seq <= ``CHUNK_THRESHOLD``)."""
    B, S, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(B, S, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(_F32)
    scores = _scale_scores(scores, hd, cfg)
    scores = softcap(scores, cfg.attn.logit_softcap)
    scores = scores + _mask_full(S, k.shape[1], causal, window, offset,
                                 q.device)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(B, S, h, hd)


def tile_plan(S: int, Skv: int, offset: int, causal: bool,
              window: Optional[int]) -> List[range]:
    """For each ``KV_CHUNK``-long key chunk, the ``KV_CHUNK``-row query
    blocks whose (query block, key chunk) tile has a live mask entry.  Row
    r sits at r + ``offset`` in the kv timeline; keys at or past ``Skv`` are
    padding.  Both bounds of the causal and window masks rise with the
    query, so the blocks form one range, and its ends never fall from one
    chunk to the next."""
    n_blocks = (S + KV_CHUNK - 1) // KV_CHUNK
    plan = []
    for k0 in range(0, Skv, KV_CHUNK):
        k1 = min(k0 + KV_CHUNK, Skv) - 1
        live = [qb for qb in range(n_blocks)
                if not (causal and k0 > min((qb + 1) * KV_CHUNK, S) - 1
                        + offset)
                and not (window is not None
                         and k1 <= qb * KV_CHUNK + offset - window)]
        plan.append(range(live[0], live[-1] + 1) if live else range(0))
    return plan


def _tile_spans(n: int) -> contextlib.ExitStack:
    """``n`` nested ``TILE_SPAN`` spans, one a computed tile."""
    stack = contextlib.ExitStack()
    for _ in range(n):
        stack.enter_context(span(TILE_SPAN))
    return stack


def chunked_attention(q, k, v, cfg: ArchConfig, causal: bool, window,
                      offset: int = 0):
    """Flash-style online softmax over ``KV_CHUNK``-long key chunks (no
    S x Skv score matrix): the reference's scan body as a Python loop, each
    chunk over the query rows of its ``tile_plan`` blocks only.

    A query row outside a chunk's blocks has no unmasked key in it.
    Computed, the chunk would leave the row's m, l and acc as they were
    (alpha 1, exact zeros added) or, before the row's first unmasked key, be
    wiped by that key's chunk (alpha 0), so every row with an unmasked key
    gets the reference's values.  The running m, l and acc cover the rows
    [r0, r1) of the blocks still to come: rows below a chunk's blocks are
    final and leave, rows above join with the reference's initial values.
    One sqrt(hd) divisor serves every chunk of a call; one
    ``repro.attn.tile`` span a computed tile wraps each chunk's work."""
    B, S, h, hd = q.shape
    kvh = k.shape[2]
    Skv = k.shape[1]
    g = h // kvh
    dev = q.device
    qg = q.reshape(B, S, kvh, g, hd)
    plan = tile_plan(S, Skv, offset, causal, window)
    pad = len(plan) * KV_CHUNK - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    div = _sqrt_hd(hd, dev) if cfg.port.score_scale is None else None
    zero = torch.zeros((), dtype=_F32, device=dev)

    def grow(state, n):
        """``state`` (m, l, acc) with ``n`` rows more, at the reference's
        initial values."""
        new = (torch.full((B, kvh, g, n), -1e30, dtype=_F32, device=dev),
               torch.zeros((B, kvh, g, n), dtype=_F32, device=dev),
               torch.zeros((B, kvh, g, n, hd), dtype=_F32, device=dev))
        if state is None:
            return new
        return tuple(torch.cat([a, b], dim=3) for a, b in zip(state, new))

    def finish(state):
        _, l, acc = state
        o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        return o.permute(0, 3, 1, 2, 4)

    state, r0, r1 = None, 0, 0      # m, l, acc of the rows [r0, r1)
    outs = []
    for ci, blocks in enumerate(plan):
        if not blocks:
            continue
        lo, hi = blocks.start * KV_CHUNK, min(blocks.stop * KV_CHUNK, S)
        if hi > r1:
            state, r1 = grow(state, hi - r1), hi
        if lo > r0:
            outs.append(finish([a[:, :, :, :lo - r0] for a in state]))
            state, r0 = [a[:, :, :, lo - r0:] for a in state], lo
        m, l, acc = state
        with _tile_spans(len(blocks)):
            kci = k[:, ci * KV_CHUNK:(ci + 1) * KV_CHUNK]
            vci = v[:, ci * KV_CHUNK:(ci + 1) * KV_CHUNK]
            qi = torch.arange(r0, r1, device=dev)[:, None] + offset
            ki = ci * KV_CHUNK + torch.arange(KV_CHUNK, device=dev)[None, :]
            s = torch.einsum("bskgd,btkd->bkgst", qg[:, r0:r1], kci).to(_F32)
            s = _scale_scores(s, hd, cfg, div)
            s = softcap(s, cfg.attn.logit_softcap)
            ok = ki < Skv
            if causal:
                ok = ok & (ki <= qi)
            if window is not None:
                ok = ok & (ki > qi - window)
            s = s + torch.where(ok, zero, zero - 1e30)[None, None, None, :, :]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + torch.sum(pexp, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", pexp.to(q.dtype), vci).to(_F32)
        state = (m_new, l, acc)
    if S > r1:      # rows that no chunk reaches: no unmasked key at all
        state = grow(state, S - r1)
    outs.append(finish(state))
    return torch.cat(outs, dim=1).reshape(B, S, h, hd)


def self_attention(p, x, cfg: ArchConfig, positions, mixer: str):
    """Training/prefill self-attention over the whole sequence."""
    window = cfg.attn.sliding_window if mixer == "attn_local" else None
    q, k, v = _project_qkv(p, x, cfg, positions)
    S = x.shape[1]
    fn = chunked_attention if S > CHUNK_THRESHOLD else full_attention
    o = fn(q, k, v, cfg, causal=True, window=window)
    return _merge_heads(p, o, cfg)


def encoder_attention(p, x, cfg: ArchConfig, positions):
    """Bidirectional (unmasked) self-attention of the encoder stack."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = full_attention(q, k, v, cfg, causal=False, window=None)
    return _merge_heads(p, o, cfg)


def cross_attention(p, x, mem_k, mem_v, cfg: ArchConfig):
    """Decoder cross-attention over precomputed encoder K/V (no RoPE)."""
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.d_head
    q = linear(x, p["wq"].to(x.dtype), "wq").reshape(B, S, h, hd)
    o = full_attention(q, mem_k, mem_v, cfg, causal=False, window=None)
    return _merge_heads(p, o, cfg)


def project_memory_kv(p, mem, cfg: ArchConfig):
    """Cross-attention K/V (B, F, kv, hd) of the encoder output ``mem``."""
    B, S, _ = mem.shape
    kv, hd = cfg.n_kv_heads, cfg.d_head
    k = linear(mem, p["wk"].to(mem.dtype), "wk").reshape(B, S, kv, hd)
    v = linear(mem, p["wv"].to(mem.dtype), "wv").reshape(B, S, kv, hd)
    return k, v


# --------------------------------------------------------------------------
# decode (single token, KV cache)
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.d_head
    return {"k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype,
                             device=device)}


def decode_self_attention(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                          pos: int, cfg: ArchConfig, mixer: str):
    """One token ``x`` (B, 1, d) at position ``pos`` against the cache: its
    K/V are written into the cache at ``pos`` (in place, the reference's
    ``dynamic_update_slice``), then the scores over the whole cache, keys
    after ``pos`` (and, for local layers, before the window) masked.
    Returns (output, cache)."""
    B = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = x.device
    positions = torch.full((B, 1), int(pos), dtype=torch.int64, device=dev)
    q, k, v = _project_qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    ck = constrain(ck, "cache_kv")
    cv = constrain(cv, "cache_kv")
    Skv = ck.shape[1]
    g = h // kvh
    qg = q.reshape(B, 1, kvh, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, ck).to(_F32)
    s = constrain(s, "decode_scores")
    s = _scale_scores(s, hd, cfg)
    s = softcap(s, cfg.attn.logit_softcap)
    ki = torch.arange(Skv, device=dev)[None, :]
    ok = ki <= pos
    window = cfg.attn.sliding_window if mixer == "attn_local" else None
    if window is not None:
        ok = ok & (ki > pos - window)
    zero = torch.zeros((), dtype=_F32, device=dev)
    s = s + torch.where(ok, zero, zero - 1e30)[None, None, None]
    w = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(B, 1, h, hd)
    return _merge_heads(p, o, cfg), cache
