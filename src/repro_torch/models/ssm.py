"""Mamba-2 block (SSD, state-space duality; port of ``repro.models.ssm``).

Prefill runs the chunked SSD algorithm: the intra-chunk quadratic term
plus inter-chunk state passing (the reference's ``lax.scan`` over chunks
as a Python loop, the state *before* each chunk kept).  Decode is the
O(1) recurrence on the (H, P, N) state.

ngroups = 1 (B/C shared across heads), a depthwise causal conv over the
[x, B, C] bundle as K shifted adds (not ``F.conv1d``, which would go to
cuDNN and its TF32 default) plus, with ``port.conv_bias``, its bias, and a
gated RMSNorm before the output projection.  Each mixer call runs inside
the profiler span ``repro.mamba``.  The four projections are plain ``@``, as in the reference:
they do not pass through the ``linear`` hook, so the analog path leaves
them exact.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch._span import spanned
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, rms_norm

_F32 = torch.float32


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.headdim
    return d_in, n_heads, s.headdim, s.d_state, s.d_conv


def mamba_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, H, P, N, K = _dims(cfg)
    conv_ch = d_in + 2 * N
    sp = {
        "w_z": ParamSpec((d, d_in), ("embed", "ffn")),
        "w_xbc": ParamSpec((d, conv_ch), ("embed", "ffn")),
        "w_dt": ParamSpec((d, H), ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), "zeros"),
        "a_log": ParamSpec((H,), ("heads",), "ones"),
        "d_skip": ParamSpec((H,), ("heads",), "ones"),
        "conv_w": ParamSpec((K, conv_ch), (None, "ffn")),
        "norm": ParamSpec((d_in,), ("ffn",), "zeros"),
        "w_out": ParamSpec((d_in, d), ("ffn", "embed")),
    }
    if cfg.port.conv_bias:
        sp["conv_b"] = ParamSpec((conv_ch,), ("ffn",), "zeros")
    return sp


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, p) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis as K shifted adds, then
    the bias where the block has one, in ``xbc``'s dtype."""
    w = p["conv_w"].to(xbc.dtype)
    K = w.shape[0]
    L = xbc.shape[1]
    out = xbc * w[K - 1]
    for i in range(1, K):
        shifted = torch.nn.functional.pad(xbc, (0, 0, i, 0))[:, :L]
        out = out + shifted * w[K - 1 - i]
    if "conv_b" in p:
        out = out + p["conv_b"].to(xbc.dtype)
    return out


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _dt(p, x: torch.Tensor, L_real: int) -> torch.Tensor:
    """softplus(x w_dt + dt_bias) in float32, zero on the padding (decay 1,
    no input), so padded positions leave the real ones untouched."""
    dt = softplus((x @ p["w_dt"].to(x.dtype)).to(_F32) + p["dt_bias"])
    L = x.shape[1]
    if L != L_real:
        valid = (torch.arange(L, device=x.device) < L_real)[None, :, None]
        dt = dt * valid
    return dt


def _chunk_states(dtc, A, Bc, xh):
    """(seg, chunk_state (B,nC,H,P,N), chunk_decay (B,nC,H)) of the chunked
    sequence."""
    da = dtc * A                                                 # (B,nC,Q,H)
    seg = torch.cumsum(da, dim=2)                                # within-chunk
    seg_last = seg[:, :, -1:, :]                                 # (B,nC,1,H)
    decay_out = torch.exp(seg_last - seg)                        # (B,nC,Q,H)
    chunk_state = torch.einsum(
        "bcqh,bcqn,bcqhp->bchpn", (decay_out * dtc).to(_F32),
        Bc.to(_F32), xh.to(_F32))
    chunk_decay = torch.exp(seg_last[:, :, 0, :])                # (B,nC,H)
    return seg, chunk_state, chunk_decay


def _scan_states(chunk_state, chunk_decay):
    """(state before each chunk (B,nC,H,P,N), final state): the
    reference's ``lax.scan`` over chunks."""
    Bsz, nC, H, P, N = chunk_state.shape
    s = torch.zeros((Bsz, H, P, N), dtype=_F32, device=chunk_state.device)
    before = []
    for c in range(nC):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    return torch.stack(before, dim=1), s


@spanned("repro.mamba")
def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, L, d) -> (B, L, d) via chunked SSD.  L may be any length: the
    sequence is zero-padded to a chunk multiple with dt masked to 0 on the
    padding."""
    B, L_real, d = x.shape
    d_in, H, P, N, K = _dims(cfg)
    Q = cfg.ssm.chunk
    pad = (-L_real) % Q
    x = _pad_seq(x, pad)
    L = L_real + pad
    nC = L // Q

    z = x @ p["w_z"].to(x.dtype)
    xbc = torch.nn.functional.silu(_causal_conv(x @ p["w_xbc"].to(x.dtype),
                                                p))
    xs, Bs, Cs = torch.split(xbc, [d_in, N, N], dim=-1)          # (B,L,*)
    dt = _dt(p, x, L_real)                                       # (B,L,H)
    A = -torch.exp(p["a_log"].to(_F32))                          # (H,)

    xh = xs.reshape(B, nC, Q, H, P)
    Bc = Bs.reshape(B, nC, Q, N)
    Cc = Cs.reshape(B, nC, Q, N)
    dtc = dt.reshape(B, nC, Q, H)
    seg, chunk_state, chunk_decay = _chunk_states(dtc, A, Bc, xh)

    # intra-chunk (quadratic in Q): decay(i,j) = exp(seg_i - seg_j) for
    # i >= j, the mask applied before the exp (masked differences are
    # positive and would overflow)
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]          # (B,nC,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, -1e30)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc.to(_F32), Bc.to(_F32))
    w_intra = cb[..., None] * decay * dtc[:, :, None, :, :]       # (B,nC,Q,Q,H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w_intra, xh.to(_F32))

    # inter-chunk state passing
    s_before, _ = _scan_states(chunk_state, chunk_decay)
    decay_in = torch.exp(seg)                                     # (B,nC,Q,H)
    y = y + torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc.to(_F32), decay_in,
                         s_before)

    y = y + p["d_skip"][None, None, None, :, None] * xh.to(_F32)
    y = y.reshape(B, L, d_in).to(x.dtype)
    y = y * torch.nn.functional.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out[:, :L_real] if pad else out


@spanned("repro.mamba")
def mamba_state_after(p, x: torch.Tensor, cfg: ArchConfig
                      ) -> Dict[str, torch.Tensor]:
    """Final (conv, ssm) state after the sequence ``x`` (B, L, d): the
    decode handoff.  The conv state is the last K-1 rows of the *unpadded*
    x w_xbc; the ssm state runs the chunk recurrence to the end (padding
    dt-masked, as ``mamba_forward``)."""
    d_in, H, P, N, K = _dims(cfg)
    B, L_real, _ = x.shape
    Q = cfg.ssm.chunk
    pad = (-L_real) % Q
    xbc_raw = x @ p["w_xbc"].to(x.dtype)
    conv_state = xbc_raw[:, L_real - (K - 1):L_real, :]
    x = _pad_seq(x, pad)
    L = L_real + pad
    nC = L // Q
    xbc = x @ p["w_xbc"].to(x.dtype)
    xbc_c = torch.nn.functional.silu(_causal_conv(xbc, p))
    xs, Bs, _ = torch.split(xbc_c, [d_in, N, N], dim=-1)
    dt = _dt(p, x, L_real)
    A = -torch.exp(p["a_log"].to(_F32))
    _, chunk_state, chunk_decay = _chunk_states(
        dt.reshape(B, nC, Q, H), A, Bs.reshape(B, nC, Q, N),
        xs.reshape(B, nC, Q, H, P))
    _, s_final = _scan_states(chunk_state, chunk_decay)
    return {"conv": conv_state, "ssm": s_final}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_mamba_cache(cfg: ArchConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    d_in, H, P, N, K = _dims(cfg)
    return {"conv": torch.zeros((batch, K - 1, d_in + 2 * N), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=_F32, device=device)}


@spanned("repro.mamba")
def mamba_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                      cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) -> (B, 1, d); the O(1) state update.  Returns the
    output and the new (conv, ssm) state."""
    B = x.shape[0]
    d_in, H, P, N, K = _dims(cfg)
    z = x @ p["w_z"].to(x.dtype)                                  # (B,1,d_in)
    xbc_new = x @ p["w_xbc"].to(x.dtype)                          # (B,1,C)
    window = torch.cat([cache["conv"], xbc_new], dim=1)           # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype))
    if "conv_b" in p:
        conv_out = conv_out + p["conv_b"].to(x.dtype)
    xbc = torch.nn.functional.silu(conv_out)[:, None, :]          # (B,1,C)
    xs, Bs, Cs = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = softplus((x @ p["w_dt"].to(x.dtype)).to(_F32)
                  + p["dt_bias"])[:, 0]                           # (B,H)
    A = -torch.exp(p["a_log"].to(_F32))
    decay = torch.exp(dt * A)                                     # (B,H)
    xh = xs[:, 0].reshape(B, H, P).to(_F32)
    Bn = Bs[:, 0].to(_F32)                                        # (B,N)
    Cn = Cs[:, 0].to(_F32)
    s_new = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bn, xh)
    y = torch.einsum("bn,bhpn->bhp", Cn, s_new) \
        + p["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = y * torch.nn.functional.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out, {"conv": window[:, 1:], "ssm": s_new}
