"""Serving engines: model execution behind a counts-reporting interface
(port of ``repro.launch.engine``).

``ServeEngine`` owns the model side of serving (DESIGN.md §11): the
parameters, the fixed-window prefill and single-token decode of
``models.model`` and their cache, and per-request frontend conditioning,
on one device.  Each call returns the
batch's next tokens (numpy, greedy argmax) plus the step's op counts
(``imc.cost_model.StepCounts``), so the serve loop runs on a simulated
device clock instead of wall time.

``StubEngine`` has the same interface with a deterministic token function
and the same analytic op counts and no model: the scheduler tests and the
step-granular serving simulator drive it.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.imc.cost_model import (StepCounts, TokenCounts,
                                        decode_step_counts, per_token_counts,
                                        prefill_step_counts)

PAD_ID = 0


def init_serve_params(cfg, seed: int, device):
    """The served model's random parameters: ``models.model.init_params``
    from a ``torch.Generator`` on ``device`` seeded with ``seed``.  The
    reference draws them with ``jax.random``; the tests hand its parameters
    over by replacing this function (or with ``ServeEngine(params=)``)."""
    from repro_torch.models import model as M

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return M.init_params(cfg, gen, device)


class ServeEngine:
    """Prefill + decode over a fixed token window on ``device`` (None =
    CUDA).

    The window (``prompt_len + max_new``) is fixed; histories are
    right-aligned into it with ``PAD_ID`` (the recompute-on-join policy:
    a join re-prefills the whole batch, and the decode cache keeps one
    shared position, see ``launch.scheduler``).  ``params`` (a tree of
    tensors, e.g. ``models.model.params_from_reference``) replaces the
    seeded init.  ``last_logits`` keeps the last call's logits."""

    def __init__(self, cfg, prompt_len: int, max_new: int, batch: int,
                 seed: int = 0, device=None, params=None):
        from repro_torch.models import model as M

        self._model = M
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.window = prompt_len + max_new
        self.max_seq = self.window + cfg.frontend_positions + max_new + 2
        self.token_counts: TokenCounts = per_token_counts(cfg)
        self.frontend_key = ("encoder_frames" if cfg.n_encoder_layers else
                             "frontend_embeds" if cfg.frontend_positions
                             else None)
        self.params = (init_serve_params(cfg, seed, self.device)
                       if params is None else M.params_to(params, self.device))
        self._cache = None
        self.last_logits: Optional[torch.Tensor] = None

    def draw_frontend(self, rng: np.random.Generator):
        """One request's frontend conditioning (vision patches or encoder
        frames, (frontend_positions, d_model) float32 normals from ``rng``),
        drawn once at admission and kept for the request's lifetime; None
        on text-only archs."""
        if self.frontend_key is None:
            return None
        return rng.standard_normal(
            (self.cfg.frontend_positions, self.cfg.d_model)).astype(np.float32)

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        self.last_logits = logits
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)

    def batch_inputs(self, histories: Sequence[np.ndarray],
                     frontends: Sequence[Any], device=None) -> dict:
        """The prefill's inputs on ``device`` (default: the engine's): the
        histories right-aligned into the window with ``PAD_ID``, and the
        slots' frontends stacked under ``frontend_key`` (zeros for a slot
        without one)."""
        dev = self.device if device is None else device
        hist = np.full((self.batch, self.window), PAD_ID, np.int64)
        for s, h in enumerate(histories):
            h = np.asarray(h)[-self.window:]
            if h.size:
                hist[s, self.window - h.size:] = h     # right-aligned
        batch = {"tokens": torch.from_numpy(hist).to(dev)}
        if self.frontend_key:
            zeros = np.zeros((self.cfg.frontend_positions, self.cfg.d_model),
                             np.float32)
            batch[self.frontend_key] = torch.from_numpy(np.stack([
                zeros if f is None else f for f in frontends])).to(dev)
        return batch

    def prefill(self, histories: Sequence[np.ndarray],
                frontends: Sequence[Any]) -> Tuple[np.ndarray, StepCounts]:
        """Re-prefill the whole batch from right-aligned histories; returns
        (next token per slot, op counts over the live histories)."""
        batch = self.batch_inputs(histories, frontends)
        with torch.no_grad():
            logits, self._cache = self._model.serve_prefill(
                self.params, self.cfg, batch, max_seq=self.max_seq)
        tok = self._next_tokens(logits)
        counts = prefill_step_counts(
            self.token_counts,
            [min(len(np.asarray(h)), self.window)
             for h in histories if len(np.asarray(h))])
        return tok, counts

    def decode_step(self, tokens: np.ndarray,
                    slot_positions: Sequence[int]
                    ) -> Tuple[np.ndarray, StepCounts]:
        """One decode step from the cached state; ``slot_positions`` are the
        per-slot history lengths (0 = idle slot), for the attention-span op
        counts only (dead slots ride the batch compute)."""
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(
            self.device)[:, None]
        with torch.no_grad():
            logits, self._cache = self._model.serve_step(
                self.params, self.cfg, self._cache, tok)
        nxt = self._next_tokens(logits)
        return nxt, decode_step_counts(self.token_counts,
                                       [p for p in slot_positions if p > 0])


class StubEngine:
    """Engine-shaped deterministic token source (no model).

    ``token_fn(slot, hist_len) -> int`` decides the next token from the
    slot index and the slot's current history length (default: a cheap
    deterministic hash, always positive).  Op counts use the same analytic
    formulas as the real engine, so a scheduler loop driven by a stub
    prices identically to one driven by a model."""

    def __init__(self, token_counts: Optional[TokenCounts] = None,
                 token_fn: Optional[Callable[[int, int], int]] = None,
                 window: Optional[int] = None):
        self.token_counts = token_counts or TokenCounts(1.0, 1.0)
        self.token_fn = token_fn or (lambda s, n: (7 * n + s) % 97 + 1)
        self.window = window

    def draw_frontend(self, rng) -> None:
        return None

    def _clip(self, n: int) -> int:
        return min(n, self.window) if self.window else n

    def prefill(self, histories: Sequence[np.ndarray],
                frontends: Sequence[Any]) -> Tuple[np.ndarray, StepCounts]:
        toks = np.array([self.token_fn(s, len(np.asarray(h)))
                         for s, h in enumerate(histories)], np.int32)
        counts = prefill_step_counts(
            self.token_counts,
            [self._clip(len(np.asarray(h)))
             for h in histories if len(np.asarray(h))])
        return toks, counts

    def decode_step(self, tokens: np.ndarray,
                    slot_positions: Sequence[int]
                    ) -> Tuple[np.ndarray, StepCounts]:
        toks = np.array([self.token_fn(s, int(p))
                         for s, p in enumerate(slot_positions)], np.int32)
        return toks, decode_step_counts(self.token_counts,
                                        [p for p in slot_positions if p > 0])
