"""Model assembly of the port: the decoder stacks of all ten archs (port of
``repro.models.model``'s full-sequence and serving paths).

Blocks: attention (global or local) or Mamba-2 mixer, dense, MoE or no
FFN, optional post-norms, and, for encoder-decoder archs, a
cross-attention sub-block over the encoder's output.  Frontend embeddings
(vision patches) are concatenated before the tokens; encoder frames go
through the encoder stack.

Parameters are nested dicts of tensors with the reference's tree paths:
per pattern position the block parameters are stacked with a leading
``layers`` axis (``blocks/pos0/attn/wq`` is (n_repeats, d, h*hd)), and the
encoder's under ``encoder/blocks`` (n_encoder_layers, ...), so a tree
exported from the reference as numpy arrays loads one to one
(``params_from_reference``).  The forward is plain functions.

Training: ``forward_train`` is the reference's logits-free loss — the
pattern loop ``_scan_pattern`` (each repeat recomputed in the backward,
as ``jax.checkpoint`` of the reference's scan body), then the
cross-entropy over ``LOSS_CHUNK``-long sequence chunks, each chunk's
logits recomputed in the backward too, so no (B, S, vocab) tensor is kept.

Logits: ``forward_logits``, decoder-only, no recompute (the analog
accuracy surface's forward).

Serving: ``init_cache`` / ``serve_prefill`` / ``serve_step``.  The cache
holds per pattern position a preallocated KV cache ((n_repeats, B,
max_seq, kv, hd)) or the Mamba conv / ssm state ((n_repeats, B, K-1, C) /
(n_repeats, B, H, P, N)), the cross K/V per pattern position for
encoder-decoder archs, one shared position ``pos`` (a Python int) and
``max_seq``.  ``serve_step`` writes the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (DTYPES, ParamSpec,
                                       abstract_params as _abstract,
                                       init_params as _init, linear,
                                       logical_axes as _axes, rms_norm,
                                       softcap)
from repro_torch.models.sharding_hooks import constrain, gather

_F32 = torch.float32
LOSS_CHUNK = 1024


def _block_specs(cfg: ArchConfig, mixer: str, ffn: str,
                 cross: bool) -> Dict[str, Any]:
    sp: Dict[str, Any] = {"ln1": ParamSpec((cfg.d_model,), ("embed",),
                                           "zeros")}
    if mixer.startswith("attn"):
        sp["attn"] = attn.attn_specs(cfg)
    elif mixer == "mamba":
        sp["mamba"] = ssm_mod.mamba_specs(cfg)
    else:
        raise ValueError(mixer)
    if cfg.post_norms:
        sp["post_ln1"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    if cross:
        sp["ln_cross"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
        sp["cross"] = attn.attn_specs(cfg, cross=True)
    if ffn != "none":
        sp["ln2"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
        sp["ffn"] = (ffn_mod.moe_specs(cfg) if ffn == "moe"
                     else ffn_mod.dense_ffn_specs(cfg))
        if cfg.post_norms:
            sp["post_ln2"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return sp


def _stack_specs(specs: Any, n: int) -> Any:
    """Add a leading stacked-layers axis to every ParamSpec."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, ("layers",) + specs.axes,
                         specs.init, specs.dtype)
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    n_rep = cfg.n_pattern_repeats
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           "embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    cross = cfg.n_encoder_layers > 0
    specs["blocks"] = {
        f"pos{i}": _stack_specs(_block_specs(cfg, mixer, f, cross), n_rep)
        for i, (mixer, f) in enumerate(cfg.pattern)}
    if cross:
        specs["encoder"] = {
            "blocks": _stack_specs(_block_specs(cfg, "attn", "dense", False),
                                   cfg.n_encoder_layers),
            "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Random parameters of ``cfg`` on ``device`` from ``generator`` (the
    reference's init scheme; its draws come from ``jax.random`` and differ
    — carry them across with ``params_from_reference``)."""
    return _init(param_specs(cfg), cfg, generator, device)


def abstract_params(cfg: ArchConfig):
    """The parameter tree on the meta device (shapes and dtypes)."""
    return _abstract(param_specs(cfg), cfg)


def logical_axes(cfg: ArchConfig):
    """The parameter tree's logical axis names, one tuple per leaf."""
    return _axes(param_specs(cfg))


def params_from_reference(tree: Any, device=None) -> Any:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's tree of
    tensors on ``device``, dtypes kept (bfloat16 leaves through float32)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_to(params, device) -> Any:
    """The parameter tree with every tensor moved to ``device``."""
    if torch.is_tensor(params):
        return params.to(device)
    return {k: params_to(v, device) for k, v in params.items()}


def _take(tree, i: int):
    return (tree[i] if torch.is_tensor(tree)
            else {k: _take(v, i) for k, v in tree.items()})


def layer_params(params, rep: int):
    """Block parameters of pattern repeat ``rep`` (the stacked axis)."""
    return _take(params["blocks"], rep)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-repeat views of a stacked tree, one ``unbind`` per
    leaf: its backward stacks the n gradients once, where n ``select``s
    would each scatter into a zero tensor of the whole stack."""
    if torch.is_tensor(tree):
        views = torch.unbind(tree)
        if len(views) != n:
            raise ValueError(f"stacked axis {len(views)}, expected {n}")
        return list(views)
    per_key = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per_key[k][i] for k in tree} for i in range(n)]


def _maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``, under autograd recomputed in the backward instead of
    keeping its intermediates (``jax.checkpoint``).  The forward draws no
    random numbers, so the RNG state is not stashed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _maybe_post(p, name, y, cfg):
    if cfg.post_norms:
        return rms_norm(y, p[name], cfg.norm_eps)
    return y


def _residual(x, y, cfg: ArchConfig):
    """``x + y``, the branch ``y`` scaled by ``cfg.port.residual_scale``
    first where it is not 1 (granite's 0.22)."""
    if cfg.port.residual_scale != 1.0:
        y = y * cfg.port.residual_scale
    return x + y


def _ffn_tail(lp, x, cfg: ArchConfig, f: str, constrained: bool = True):
    """The block's FFN half (pre-norm, dense or MoE FFN, post-norm,
    residual, then the ``act_btd`` constraint unless ``constrained`` is
    False: the reference's decode step has none).  Returns (x, aux loss or
    None)."""
    if f == "none":
        return x, None
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    aux = None
    if f == "moe":
        y, aux = ffn_mod.moe_ffn(lp["ffn"], h, cfg)
    else:
        y = ffn_mod.dense_ffn(lp["ffn"], h, cfg)
    x = _residual(x, _maybe_post(lp, "post_ln2", y, cfg), cfg)
    return (constrain(x, "act_btd") if constrained else x), aux


def _cross_tail(lp, x, cfg: ArchConfig, mem_kv):
    """The cross-attention sub-block over the encoder's K/V (if any)."""
    if mem_kv is None:
        return x
    h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    return x + attn.cross_attention(lp["cross"], h, mem_kv[0], mem_kv[1],
                                    cfg)


def _run_block(p, x, cfg: ArchConfig, mixer: str, ffn: str, positions,
               mem_kv=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block (train/prefill).  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mixer.startswith("attn"):
        y = attn.self_attention(p["attn"], h, cfg, positions, mixer)
    else:
        y = ssm_mod.mamba_forward(p["mamba"], h, cfg)
    x = constrain(_residual(x, _maybe_post(p, "post_ln1", y, cfg), cfg),
                  "act_btd")
    x = _cross_tail(p, x, cfg, mem_kv)
    x, a = _ffn_tail(p, x, cfg, ffn)
    return x, aux if a is None else aux + a


def _scan_pattern(blocks, x, cfg: ArchConfig, positions, enc_out=None,
                  remat: bool = True):
    """The repeating pattern over its stacked parameters ``blocks`` (the
    reference's ``lax.scan`` as a loop over repeats), each repeat one
    remat region with ``remat``.  With ``enc_out`` (encoder-decoder), each
    block projects its cross K/V from it inside the region.  Returns (x,
    the summed aux loss): the MoE aux leaves each region as an output."""
    def body(x, aux, lps):
        lps = gather(lps, "blocks")
        for i, (mixer, f) in enumerate(cfg.pattern):
            lp = lps[f"pos{i}"]
            kv = (None if enc_out is None else
                  attn.project_memory_kv(lp["cross"], enc_out, cfg))
            x, a = _run_block(lp, x, cfg, mixer, f, positions, kv)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=_F32, device=x.device)
    for lps in _unstack(blocks, cfg.n_pattern_repeats):
        x, aux = _maybe_remat(body, remat, x, aux, lps)
    return x, aux


def _embed(params, cfg: ArchConfig, tokens, frontend_embeds=None):
    """Token embedding in the compute dtype, scaled by sqrt(d_model) — the
    scale as a float32 square root rounded to the compute dtype, as the
    reference's weakly typed ``jnp.sqrt(float(d))`` — or by
    ``cfg.port.embed_scale`` where set, with ``frontend_embeds`` (B, F, d)
    concatenated before the tokens."""
    dt = DTYPES[cfg.compute_dtype]
    e = params["embed"]
    if cfg.port.embed_scale is None:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=_F32,
                                        device=e.device)).to(dt)
    else:
        scale = torch.tensor(float(cfg.port.embed_scale), dtype=_F32,
                             device=e.device).to(dt)
    x = e[tokens].to(dt) * scale
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(dt), x], dim=1)
    return constrain(x, "act_btd")


def _unembed_matrix(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _scaled_logits(logits, cfg: ArchConfig):
    """float32 logits divided by ``cfg.port.logits_scaling`` (where it is
    not 1), then soft-capped."""
    logits = logits.to(_F32)
    if cfg.port.logits_scaling != 1.0:
        logits = logits / cfg.port.logits_scaling
    return softcap(logits, cfg.final_softcap)


def _logits(params, cfg: ArchConfig, h):
    w = _unembed_matrix(params, cfg)
    logits = linear(h, w.to(h.dtype), "unembed")
    return constrain(_scaled_logits(logits, cfg), "logits")


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.arange(S, device=device)[None], (B, S))


# --------------------------------------------------------------------------
# encoder (enc-dec archs)
# --------------------------------------------------------------------------
def _encode(params, cfg: ArchConfig, frame_embeds, remat: bool = False):
    """The encoder stack over ``frame_embeds`` (B, F, d): bidirectional
    attention + dense FFN per layer (each layer one remat region with
    ``remat``), then the final norm."""
    x = constrain(frame_embeds.to(DTYPES[cfg.compute_dtype]), "act_btd")
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    enc = params["encoder"]

    def layer(x, lp):
        lp = gather(lp, "encoder/blocks")
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.encoder_attention(lp["attn"], h, cfg, positions)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return constrain(x + ffn_mod.dense_ffn(lp["ffn"], h, cfg), "act_btd")

    for lp in _unstack(enc["blocks"], cfg.n_encoder_layers):
        x = _maybe_remat(layer, remat, x, lp)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _cross_kv(params, cfg: ArchConfig, enc_out):
    """Per pattern position, the cross K/V of every repeat, stacked:
    ((n_repeats, B, F, kv, hd), same)."""
    kv = {f"pos{i}": [] for i in range(len(cfg.pattern))}
    for r in range(cfg.n_pattern_repeats):
        cross = gather({pos: {"cross": {w: params["blocks"][pos]["cross"][w][r]
                                        for w in ("wk", "wv")}}
                        for pos in kv}, "blocks")
        for pos, lst in kv.items():
            lst.append(attn.project_memory_kv(cross[pos]["cross"], enc_out,
                                              cfg))
    return {pos: (torch.stack([k for k, _ in lst]),
                  torch.stack([v for _, v in lst]))
            for pos, lst in kv.items()}


# --------------------------------------------------------------------------
# full-sequence logits (decoder-only)
# --------------------------------------------------------------------------
def forward_logits(params, cfg: ArchConfig, tokens):
    """(B, S, vocab) logits of a decoder-only arch: embedding, the pattern
    without recompute, final norm, unembed."""
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    x, _ = _scan_pattern(params["blocks"], x, cfg, _positions(B, S, x.device),
                         remat=False)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)


# --------------------------------------------------------------------------
# training forward (chunked CE loss; no (B, S, vocab) tensor kept)
# --------------------------------------------------------------------------
def _ce_chunk(h, labels, w, cfg: ArchConfig):
    """[sum of token CE, valid tokens] of one chunk; labels -1 are
    padding."""
    logits = _scaled_logits(h @ w, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp_min(labels, 0)[..., None])
    valid = (labels >= 0).to(_F32)
    return torch.stack([torch.sum((logz - gold[..., 0]) * valid),
                        torch.sum(valid)])


def forward_train(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Returns (loss, {"ce", "aux", "tokens"}).  batch: tokens (B, S),
    labels (B, S) with -1 = padding, optional ``frontend_embeds`` (B, F,
    d) before the tokens or, for encoder-decoder archs,
    ``encoder_frames``.  Frontend positions carry no label: they are
    stripped before the loss.  loss = mean token CE + the MoE aux loss."""
    tokens = batch["tokens"]
    labels = batch["labels"].long()
    fe = batch.get("frontend_embeds")
    enc_out = None
    if cfg.n_encoder_layers:
        enc_out = _encode(params, cfg, batch["encoder_frames"], remat=True)
        x = _embed(params, cfg, tokens)
    else:
        x = _embed(params, cfg, tokens, fe)
    B, S, _ = x.shape
    x, aux = _scan_pattern(params["blocks"], x, cfg,
                           _positions(B, S, x.device), enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if fe is not None:
        x = x[:, fe.shape[1]:]

    w = _unembed_matrix(params, cfg).to(x.dtype)
    S_txt = x.shape[1]
    n_chunks = max(1, S_txt // LOSS_CHUNK)
    if S_txt % n_chunks:
        raise ValueError(f"{S_txt} text positions do not split into "
                         f"{n_chunks} loss chunks")
    L = S_txt // n_chunks
    totals = torch.zeros(2, dtype=_F32, device=x.device)
    for c in range(n_chunks):
        totals = totals + _maybe_remat(
            _ce_chunk, True, x[:, c * L:(c + 1) * L],
            labels[:, c * L:(c + 1) * L], w, cfg)
    ce = totals[0] / torch.clamp_min(totals[1], 1.0)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": totals[1]}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Any]:
    """Zero decode cache at position 0: per pattern position the KV cache
    (attention, compute dtype) or the Mamba conv (compute dtype) and ssm
    (float32) state, stacked over the repeats; the cross K/V of
    ``frontend_positions`` rows for encoder-decoder archs."""
    dt = DTYPES[cfg.compute_dtype]
    n_rep = cfg.n_pattern_repeats
    blocks = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer.startswith("attn"):
            c = attn.init_kv_cache(cfg, batch, max_seq, dt, device)
        else:
            c = ssm_mod.init_mamba_cache(cfg, batch, dt, device)
        blocks[f"pos{i}"] = {k: v.new_zeros((n_rep,) + tuple(v.shape))
                             for k, v in c.items()}
    cache: Dict[str, Any] = {"pos": 0, "max_seq": max_seq, "blocks": blocks}
    if cfg.n_encoder_layers:
        shape = (n_rep, batch, cfg.frontend_positions, cfg.n_kv_heads,
                 cfg.d_head)
        cache["cross"] = {
            f"pos{i}": (torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device))
            for i in range(len(cfg.pattern))}
    return cache


def _window(cfg: ArchConfig, mixer: str):
    return cfg.attn.sliding_window if mixer == "attn_local" else None


def serve_prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                  max_seq: int):
    """Full forward over ``batch["tokens"]`` (B, S), after
    ``batch["frontend_embeds"]`` (B, F, d) if given, and with the encoder
    run once over ``batch["encoder_frames"]`` for encoder-decoder archs.
    Returns the last position's logits (B, 1, vocab) and the cache filled
    to ``pos`` = F + S.  Above ``attention.CHUNK_THRESHOLD`` positions the
    attention is chunked."""
    x = _embed(params, cfg, batch["tokens"], batch.get("frontend_embeds"))
    B, S, _ = x.shape
    if S > max_seq:
        raise ValueError(f"prefill of {S} positions exceeds max_seq "
                         f"{max_seq}")
    positions = _positions(B, S, x.device)
    cache = init_cache(cfg, B, max_seq, x.device)
    cross = None
    if cfg.n_encoder_layers:
        cross = _cross_kv(params, cfg,
                          _encode(params, cfg, batch["encoder_frames"]))
        cache["cross"] = cross
    fn = (attn.chunked_attention if S > attn.CHUNK_THRESHOLD
          else attn.full_attention)

    def repeat(x, rep):
        # a function, so a sharded rank's gathered weights die with it
        lps = gather(layer_params(params, rep), "blocks")
        for i, (mixer, f) in enumerate(cfg.pattern):
            lp = lps[f"pos{i}"]
            c = cache["blocks"][f"pos{i}"]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if mixer.startswith("attn"):
                q, k, v = attn._project_qkv(lp["attn"], h, cfg, positions)
                o = fn(q, k, v, cfg, causal=True, window=_window(cfg, mixer))
                y = attn._merge_heads(lp["attn"], o, cfg)
                c["k"][rep, :, :S] = k
                c["v"][rep, :, :S] = v
            else:
                y = ssm_mod.mamba_forward(lp["mamba"], h, cfg)
                st = ssm_mod.mamba_state_after(lp["mamba"], h, cfg)
                c["conv"][rep] = st["conv"]
                c["ssm"][rep] = st["ssm"]
            x = constrain(_residual(x, _maybe_post(lp, "post_ln1", y, cfg),
                                    cfg), "act_btd")
            if cross is not None:
                kc, vc = cross[f"pos{i}"]
                x = _cross_tail(lp, x, cfg, (kc[rep], vc[rep]))
            x, _ = _ffn_tail(lp, x, cfg, f)
        return x

    for rep in range(cfg.n_pattern_repeats):
        x = repeat(x, rep)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1:, :])
    cache["pos"] = S
    return logits, cache


def serve_step(params, cfg: ArchConfig, cache: Dict[str, Any],
               tokens: torch.Tensor):
    """One decode step: ``tokens`` (B, 1) at the cache's position.  Returns
    (logits (B, 1, vocab), cache), the cache written in place and its
    position advanced by one."""
    pos = int(cache["pos"])
    max_seq = int(cache["max_seq"])
    if pos >= max_seq:
        raise ValueError(f"decode at position {pos} past max_seq {max_seq}")
    x = _embed(params, cfg, tokens)

    def repeat(x, rep):
        # a function, so a sharded rank's gathered weights and cache die
        # with it
        lps = gather(layer_params(params, rep), "blocks")
        # the repeat's cache: views into the stacked cache (written in
        # place), or a sharded rank's gathered copies (site "cache")
        rc = {"blocks": {key: {k: v[rep] for k, v in c.items()}
                         for key, c in cache["blocks"].items()}}
        if "cross" in cache:
            rc["cross"] = {key: (kc[rep], vc[rep])
                           for key, (kc, vc) in cache["cross"].items()}
        rc = gather(rc, "cache")
        for i, (mixer, f) in enumerate(cfg.pattern):
            lp = lps[f"pos{i}"]
            c = rc["blocks"][f"pos{i}"]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if mixer.startswith("attn"):
                y, _ = attn.decode_self_attention(lp["attn"], h, c, pos, cfg,
                                                  mixer)
            else:
                y, st = ssm_mod.mamba_decode_step(lp["mamba"], h, c, cfg)
                c["conv"].copy_(st["conv"])
                c["ssm"].copy_(st["ssm"])
            x = _residual(x, _maybe_post(lp, "post_ln1", y, cfg), cfg)
            if "cross" in rc:
                x = _cross_tail(lp, x, cfg, rc["cross"][f"pos{i}"])
            x, _ = _ffn_tail(lp, x, cfg, f, constrained=False)
        return x

    for rep in range(cfg.n_pattern_repeats):
        x = repeat(x, rep)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache


def n_params(params) -> int:
    if torch.is_tensor(params):
        return params.numel()
    return sum(n_params(v) for v in params.values())

