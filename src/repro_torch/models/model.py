"""Model assembly of the port: decoder-only stacks of attention + dense FFN
blocks (port of the full-sequence path of ``repro.models.model``).

Parameters are nested dicts of tensors with the reference's tree paths:
per pattern position the block parameters are stacked with a leading
``layers`` axis (``blocks/pos0/attn/wq`` is (n_repeats, d, h*hd)), so a
tree exported from the reference as numpy arrays loads one to one
(``params_from_reference``).  The forward is plain functions; the layer
loop lives in ``imc.model_analog._forward_unrolled``, as in the reference.
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


def layer_params(params, rep: int):
    """Block parameters of pattern repeat ``rep`` (the stacked axis)."""
    def take(t):
        return t[rep] if torch.is_tensor(t) else {k: take(v) for k, v in t.items()}

    return take(params["blocks"])


def _maybe_post(p, name, y, cfg):
    if cfg.post_norms:
        return rms_norm(y, p[name], cfg.norm_eps)
    return y


def _run_block(p, x, cfg: ArchConfig, mixer: str, ffn: str, positions
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block (train/prefill).  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y = attn.self_attention(p["attn"], h, cfg, positions, mixer)
    x = x + _maybe_post(p, "post_ln1", y, cfg)
    if ffn != "none":
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y = ffn_mod.dense_ffn(p["ffn"], h, cfg)
        x = x + _maybe_post(p, "post_ln2", y, cfg)
    return x, aux


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


def n_params(params) -> int:
    if torch.is_tensor(params):
        return params.numel()
    return sum(n_params(v) for v in params.values())
