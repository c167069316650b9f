"""Model assembly of the port: decoder-only stacks of attention + dense FFN
blocks (port of ``repro.models.model``'s full-sequence and serving paths).

Parameters are nested dicts of tensors with the reference's tree paths:
per pattern position the block parameters are stacked with a leading
``layers`` axis (``blocks/pos0/attn/wq`` is (n_repeats, d, h*hd)), so a
tree exported from the reference as numpy arrays loads one to one
(``params_from_reference``).  The forward is plain functions; the
full-sequence layer loop lives in ``imc.model_analog._forward_unrolled``,
as in the reference.

Serving: ``init_cache`` / ``serve_prefill`` / ``serve_step`` with a
preallocated KV cache per pattern position, stacked like the parameters
((n_repeats, B, max_seq, kv, hd)), and one shared position ``pos`` (a
Python int).  ``serve_step`` writes the cache in place and returns it.
They cover attention mixers (global and local) with dense or no FFN; Mamba
state, MoE, cross-attention and frontend embeddings raise
``NotImplementedError`` (ROADMAP A9b).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (DTYPES, ParamSpec,
                                       init_params as _init, linear, rms_norm,
                                       softcap)

_F32 = torch.float32


def _block_specs(cfg: ArchConfig, mixer: str, ffn: str) -> Dict[str, Any]:
    if not mixer.startswith("attn") or ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"{cfg.name}: ({mixer}, {ffn}) blocks are not ported (ROADMAP "
            f"A9b); the port runs attention + dense FFN decoders")
    sp: Dict[str, Any] = {"ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
                          "attn": attn.attn_specs(cfg)}
    if cfg.post_norms:
        sp["post_ln1"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    if ffn != "none":
        sp["ln2"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
        sp["ffn"] = ffn_mod.dense_ffn_specs(cfg)
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
    if cfg.n_encoder_layers:
        raise NotImplementedError("encoder-decoder stacks are not ported "
                                  "(ROADMAP A9b)")
    n_rep = cfg.n_pattern_repeats
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           "embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    specs["blocks"] = {
        f"pos{i}": _stack_specs(_block_specs(cfg, mixer, f), n_rep)
        for i, (mixer, f) in enumerate(cfg.pattern)}
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator, device):
    """Random parameters of ``cfg`` on ``device`` from ``generator`` (the
    reference's init scheme; its draws come from ``jax.random`` and differ
    — carry them across with ``params_from_reference``)."""
    return _init(param_specs(cfg), cfg, generator, device)


def params_from_reference(tree: Any, device=None) -> Any:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's tree of
    tensors on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_to(params, device) -> Any:
    """The parameter tree with every tensor moved to ``device``."""
    if torch.is_tensor(params):
        return params.to(device)
    return {k: params_to(v, device) for k, v in params.items()}


def layer_params(params, rep: int):
    """Block parameters of pattern repeat ``rep`` (the stacked axis)."""
    def take(t):
        return t[rep] if torch.is_tensor(t) else {k: take(v) for k, v in t.items()}

    return take(params["blocks"])


def _maybe_post(p, name, y, cfg):
    if cfg.post_norms:
        return rms_norm(y, p[name], cfg.norm_eps)
    return y


def _ffn_tail(lp, x, cfg: ArchConfig, f: str):
    """The block's FFN half (pre-norm, dense FFN, post-norm, residual)."""
    if f != "none":
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y = ffn_mod.dense_ffn(lp["ffn"], h, cfg)
        x = x + _maybe_post(lp, "post_ln2", y, cfg)
    return x


def _run_block(p, x, cfg: ArchConfig, mixer: str, ffn: str, positions
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block (train/prefill).  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y = attn.self_attention(p["attn"], h, cfg, positions, mixer)
    x = x + _maybe_post(p, "post_ln1", y, cfg)
    return _ffn_tail(p, x, cfg, ffn), aux


def _embed(params, cfg: ArchConfig, tokens):
    """Token embedding in the compute dtype, scaled by sqrt(d_model) — the
    scale as a float32 square root rounded to the compute dtype, as the
    reference's weakly typed ``jnp.sqrt(float(d))``."""
    dt = DTYPES[cfg.compute_dtype]
    e = params["embed"]
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=_F32)).to(dt)
    return e[tokens].to(dt) * scale.to(e.device)


def _unembed_matrix(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _logits(params, cfg: ArchConfig, h):
    w = _unembed_matrix(params, cfg)
    logits = linear(h, w.to(h.dtype), "unembed")
    return softcap(logits.to(_F32), cfg.final_softcap)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def check_serving(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the serving path covers every
    block of ``cfg`` (attention mixers, dense or no FFN, no encoder, no
    frontend)."""
    for mixer, f in cfg.pattern:
        if not mixer.startswith("attn") or f not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: serving ({mixer}, {f}) blocks (Mamba state, "
                f"MoE) is not ported (ROADMAP A9b)")
    if cfg.n_encoder_layers:
        raise NotImplementedError(f"{cfg.name}: cross-attention serving is "
                                  f"not ported (ROADMAP A9b)")
    if cfg.frontend_positions:
        raise NotImplementedError(f"{cfg.name}: frontend embeddings are not "
                                  f"ported (ROADMAP A9b)")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> Dict[str, Any]:
    """Zero KV cache per pattern position, (n_repeats, batch, max_seq, kv,
    hd) in the compute dtype, at position 0."""
    check_serving(cfg)
    dt = DTYPES[cfg.compute_dtype]
    n_rep = cfg.n_pattern_repeats
    blocks = {}
    for i in range(len(cfg.pattern)):
        c = attn.init_kv_cache(cfg, batch, max_seq, dt, device)
        blocks[f"pos{i}"] = {k: v.new_zeros((n_rep,) + tuple(v.shape))
                             for k, v in c.items()}
    return {"pos": 0, "blocks": blocks}


def _window(cfg: ArchConfig, mixer: str):
    return cfg.attn.sliding_window if mixer == "attn_local" else None


def serve_prefill(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                  max_seq: int):
    """Full forward over ``batch["tokens"]`` (B, S); returns the last
    position's logits (B, 1, vocab) and the cache filled to ``pos`` = S.
    Above ``attention.CHUNK_THRESHOLD`` tokens the attention is chunked."""
    check_serving(cfg)
    if batch.get("frontend_embeds") is not None or "encoder_frames" in batch:
        raise NotImplementedError("frontend / encoder inputs are not ported "
                                  "(ROADMAP A9b)")
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    if S > max_seq:
        raise ValueError(f"prefill of {S} tokens exceeds max_seq {max_seq}")
    positions = torch.broadcast_to(
        torch.arange(S, device=x.device)[None], (B, S))
    cache = init_cache(cfg, B, max_seq, x.device)
    fn = (attn.chunked_attention if S > attn.CHUNK_THRESHOLD
          else attn.full_attention)
    for rep in range(cfg.n_pattern_repeats):
        lps = layer_params(params, rep)
        for i, (mixer, f) in enumerate(cfg.pattern):
            lp = lps[f"pos{i}"]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attn._project_qkv(lp["attn"], h, cfg, positions)
            o = fn(q, k, v, cfg, causal=True, window=_window(cfg, mixer))
            y = attn._merge_heads(lp["attn"], o, cfg)
            c = cache["blocks"][f"pos{i}"]
            c["k"][rep, :, :S] = k
            c["v"][rep, :, :S] = v
            x = x + _maybe_post(lp, "post_ln1", y, cfg)
            x = _ffn_tail(lp, x, cfg, f)
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
    max_seq = cache["blocks"]["pos0"]["k"].shape[2]
    if pos >= max_seq:
        raise ValueError(f"decode at position {pos} past max_seq {max_seq}")
    x = _embed(params, cfg, tokens)
    for rep in range(cfg.n_pattern_repeats):
        lps = layer_params(params, rep)
        for i, (mixer, f) in enumerate(cfg.pattern):
            lp = lps[f"pos{i}"]
            c = cache["blocks"][f"pos{i}"]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, _ = attn.decode_self_attention(
                lp["attn"], h, {"k": c["k"][rep], "v": c["v"][rep]}, pos,
                cfg, mixer)
            x = x + _maybe_post(lp, "post_ln1", y, cfg)
            x = _ffn_tail(lp, x, cfg, f)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache


def n_params(params) -> int:
    if torch.is_tensor(params):
        return params.numel()
    return sum(n_params(v) for v in params.values())
