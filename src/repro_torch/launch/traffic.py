"""Arrival processes and request-shape distributions for serving studies
(the port's own copy of ``repro.launch.traffic``; numpy only).

Generates the traffic the serving simulator (``launch.simulate``) replays:
Poisson arrivals (or a trace file) with mixed prompt/output-length
distributions, vectorized in numpy so millions of requests materialize in
milliseconds (DESIGN.md §11).

A ``Trace`` is three parallel arrays — arrival time [s, sorted], prompt
tokens, output tokens — the only contract the simulator, the scheduler
loop, and the report layer share.  ``Trace.save``/``Trace.load`` round-trip
``.npz`` (bulk) and ``.jsonl`` (hand-editable) files, so measured
production traces slot in where the synthetic generator was.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthMixture:
    """Mixture of clipped lognormal length components.

    ``components``: ``(weight, median_tokens, log_sigma)`` triples — e.g.
    short chat turns mixed with long document prompts.  Weights are
    normalized; samples are rounded and clipped to ``[lo, hi]``.
    """

    components: Tuple[Tuple[float, float, float], ...]
    lo: int = 1
    hi: int = 8192

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        w = np.array([c[0] for c in self.components], np.float64)
        idx = rng.choice(len(self.components), size=n, p=w / w.sum())
        med = np.array([c[1] for c in self.components])[idx]
        sig = np.array([c[2] for c in self.components])[idx]
        out = np.rint(med * np.exp(sig * rng.standard_normal(n)))
        return np.clip(out, self.lo, self.hi).astype(np.int64)

    def mean(self) -> float:
        """Analytic mean (unclipped lognormal): E = median * exp(sigma^2/2)."""
        w = np.array([c[0] for c in self.components], np.float64)
        w = w / w.sum()
        med = np.array([c[1] for c in self.components])
        sig = np.array([c[2] for c in self.components])
        return float(np.sum(w * med * np.exp(sig ** 2 / 2.0)))

    def mean_sq(self) -> float:
        """Analytic second moment: E[L^2] = median^2 * exp(2 sigma^2).

        The quadratic (position-linear attention) cost terms scale with
        E[L^2], not E[L]^2 — for heavy-tailed length mixtures the variance
        contribution dominates, so capacity estimates built from first
        moments alone saturate early."""
        w = np.array([c[0] for c in self.components], np.float64)
        w = w / w.sum()
        med = np.array([c[1] for c in self.components])
        sig = np.array([c[2] for c in self.components])
        return float(np.sum(w * med ** 2 * np.exp(2.0 * sig ** 2)))


# chat-plus-documents defaults: mostly short prompts with a heavy long tail,
# short-to-medium generations
CHAT_PROMPTS = LengthMixture(((0.8, 64.0, 0.6), (0.2, 512.0, 0.5)), lo=4,
                             hi=4096)
CHAT_OUTPUTS = LengthMixture(((0.7, 32.0, 0.7), (0.3, 128.0, 0.5)), lo=1,
                             hi=1024)


@dataclasses.dataclass(frozen=True)
class Trace:
    """Arrival times [s, ascending] + per-request prompt/output lengths."""

    arrival_s: np.ndarray
    prompt_tokens: np.ndarray
    output_tokens: np.ndarray

    def __post_init__(self):
        n = len(self.arrival_s)
        assert len(self.prompt_tokens) == n and len(self.output_tokens) == n
        if n > 1:
            assert np.all(np.diff(self.arrival_s) >= 0), "arrivals unsorted"

    def __len__(self) -> int:
        return len(self.arrival_s)

    @property
    def total_output_tokens(self) -> int:
        return int(self.output_tokens.sum())

    def save(self, path) -> None:
        path = Path(path)
        if path.suffix == ".jsonl":
            with open(path, "w") as f:
                for a, p, o in zip(self.arrival_s, self.prompt_tokens,
                                   self.output_tokens):
                    f.write(json.dumps({"arrival_s": float(a),
                                        "prompt_tokens": int(p),
                                        "output_tokens": int(o)}) + "\n")
        else:
            np.savez_compressed(path, arrival_s=self.arrival_s,
                                prompt_tokens=self.prompt_tokens,
                                output_tokens=self.output_tokens)

    @staticmethod
    def load(path) -> "Trace":
        path = Path(path)
        if path.suffix == ".jsonl":
            rows = [json.loads(line) for line in open(path) if line.strip()]
            return Trace(
                np.array([r["arrival_s"] for r in rows], np.float64),
                np.array([r["prompt_tokens"] for r in rows], np.int64),
                np.array([r["output_tokens"] for r in rows], np.int64))
        with np.load(path) as z:
            return Trace(z["arrival_s"].astype(np.float64),
                         z["prompt_tokens"].astype(np.int64),
                         z["output_tokens"].astype(np.int64))


@dataclasses.dataclass(frozen=True)
class PoissonTraffic:
    """Homogeneous Poisson arrivals at ``rate`` requests/simulated-second
    with mixture-distributed prompt/output lengths."""

    rate: float
    n_requests: int
    prompts: LengthMixture = CHAT_PROMPTS
    outputs: LengthMixture = CHAT_OUTPUTS
    seed: int = 0

    def trace(self) -> Trace:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, self.n_requests)
        return Trace(np.cumsum(gaps),
                     self.prompts.sample(rng, self.n_requests),
                     self.outputs.sample(rng, self.n_requests))


def mean_request_time(prices, prompts: LengthMixture,
                      outputs: LengthMixture,
                      n_slots: int = 1) -> float:
    """Expected device time one request costs the system under
    ``TokenPrices``: the prefill of its prompt, each generated token at its
    growing context position, and — when ``n_slots > 1`` — the
    recompute-on-join tax its admission levies on the batch (the join
    re-prefills every other live slot's history, mean length ≈ prompt plus
    half the output).  Queueing delay is excluded — this is the service-time
    scale the capacity estimate divides by, not the loaded latency.

    Quadratic terms use second moments (``mean_sq``): with heavy-tailed
    length mixtures ``E[L^2] >> E[L]^2`` and the position-linear attention
    cost is driven by the tail, not the typical request."""
    p, o = prompts.mean(), outputs.mean()
    p2, o2 = prompts.mean_sq(), outputs.mean_sq()
    t_prefill = p * prices.t_tok + prices.t_pos * (p2 - p) / 2.0
    # decode tokens 2..o run at positions p+1 .. p+o-1
    n_dec = max(o - 1.0, 0.0)
    t_decode = n_dec * prices.t_tok + prices.t_pos * (
        n_dec * p + max(o2 - o, 0.0) / 2.0)
    # recompute-on-join: each admission re-prefills the other live slots;
    # a live history is its prompt plus a uniform fraction of its output
    # (h = p + u*o, u ~ U[0,1] => E[h] = p + o/2, E[h^2] below)
    h = p + o / 2.0
    h2 = p2 + p * o + o2 / 3.0
    t_join = (n_slots - 1) * (h * prices.t_tok
                              + prices.t_pos * (h2 - h) / 2.0)
    return t_prefill + t_decode + t_join


def rate_for_load(prices, rho: float, n_slots: int,
                  prompts: LengthMixture = CHAT_PROMPTS,
                  outputs: LengthMixture = CHAT_OUTPUTS) -> float:
    """Arrival rate [req/s] giving offered load ``rho`` for a technology
    priced by ``prices``: ``rho`` = 1 saturates the estimated capacity
    ``1 / E[service time]``.  The device clock is *serial* — every slot's
    ops are charged to the same device — so slot count does not multiply
    capacity; it only sets the recompute-on-join tax (which dominates the
    per-request service time at wide batches).  Offered load is defined
    relative to each technology's *own* capacity, so the same ``rho`` is
    comparable across afmtj/mtj/cpu."""
    return rho / mean_request_time(prices, prompts, outputs, n_slots=n_slots)


def poisson_at_load(prices, rho: float, n_requests: int, n_slots: int,
                    prompts: LengthMixture = CHAT_PROMPTS,
                    outputs: LengthMixture = CHAT_OUTPUTS,
                    seed: int = 0) -> PoissonTraffic:
    """Convenience: Poisson traffic at normalized offered load ``rho``."""
    return PoissonTraffic(rate_for_load(prices, rho, n_slots, prompts,
                                        outputs),
                          n_requests, prompts, outputs, seed)
