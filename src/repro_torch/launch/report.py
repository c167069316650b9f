"""Serving-report layer: tail latency, efficiency, and SLO attainment (the
port's own copy of ``repro.launch.report``; numpy only).

Turns the raw per-request arrays a serving run produces (time-to-first-token,
finish time, token counts — wherever they came from: the event-driven
simulator, the scheduler loop, or the real engine loop) into the numbers
the case study reports per technology (DESIGN.md §11):

* p50/p99 time-to-first-token (TTFT) and per-output-token latency (TPOT),
* throughput (tokens / simulated second) and energy efficiency
  (tokens / joule),
* SLO attainment — the fraction of requests meeting a (TTFT, TPOT) bound —
  as a function of offered load.

SLOs are expressed as multiples of the serving policy's *structural* cost
under each technology's token prices (``SLO.normalized``): the admission
wave for TTFT and the saturated per-token service time for TPOT.  A "1.5x"
bound then means the same thing for a CPU and an AFMTJ array even though
their absolute clocks differ by orders of magnitude, and attainment
measures queueing degradation — the quantity that collapses past offered
load 1.  Absolute-seconds SLOs are also supported for cross-technology
floors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective: TTFT and per-token bounds [s]."""

    ttft_s: float
    tpot_s: float

    @staticmethod
    def normalized(prices, prompts, outputs, n_slots: int,
                   ttft_mult: float = 1.5, tpot_mult: float = 1.5) -> "SLO":
        """Bounds as multiples of the serving policy's *structural* cost
        under ``TokenPrices`` — what a request pays even with no queue:

        * TTFT baseline: one full admission wave — the recompute-on-join
          policy re-prefills every live history (``n_slots`` of mean
          steady-state length) before the joiner's first token can exist.
        * TPOT baseline: the saturated per-token service time — the
          request's share of total device work (own tokens + join tax)
          spread over its output.

        Multiples of these measure *queueing* degradation, which is the
        quantity that collapses past ``rho = 1``; normalizing instead to a
        single unloaded prefill would put the bar below the policy floor
        and report zero attainment at every load."""
        from repro_torch.launch.traffic import mean_request_time

        p, o = prompts.mean(), outputs.mean()
        h = int(round(p + o / 2.0))
        base_ttft = n_slots * prices.prefill(h).t
        base_tpot = mean_request_time(prices, prompts, outputs,
                                      n_slots=n_slots) / max(o, 1.0)
        return SLO(ttft_s=ttft_mult * base_ttft, tpot_s=tpot_mult * base_tpot)


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """One (technology, offered load) cell of the serving study."""

    technology: str
    n_requests: int
    offered_load: Optional[float]
    sim_time_s: float                # simulated clock at last completion
    energy_j: float
    prefill_tokens: int
    decode_tokens: int
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    slo_attainment: Optional[float] = None
    utilization: Optional[float] = None  # busy device time / sim time

    @property
    def generated_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def throughput_tok_s(self) -> float:
        return self.generated_tokens / self.sim_time_s if self.sim_time_s \
            else 0.0

    @property
    def tokens_per_joule(self) -> float:
        return self.generated_tokens / self.energy_j if self.energy_j \
            else math.inf

    def row_dict(self) -> Dict[str, float]:
        """Flat dict for BENCH.json-style emission."""
        d = {
            "requests": self.n_requests,
            "sim_time_s": self.sim_time_s,
            "energy_j": self.energy_j,
            "ttft_p50_s": self.ttft_p50_s,
            "ttft_p99_s": self.ttft_p99_s,
            "tpot_p50_s": self.tpot_p50_s,
            "tpot_p99_s": self.tpot_p99_s,
            "throughput_tok_s": self.throughput_tok_s,
            "tokens_per_joule": self.tokens_per_joule,
        }
        if self.offered_load is not None:
            d["offered_load"] = self.offered_load
        if self.slo_attainment is not None:
            d["slo_attainment"] = self.slo_attainment
        if self.utilization is not None:
            d["utilization"] = self.utilization
        return d


def build_report(technology: str, ttft_s: np.ndarray, tpot_s: np.ndarray,
                 sim_time_s: float, energy_j: float, prefill_tokens: int,
                 decode_tokens: int, offered_load: Optional[float] = None,
                 slo: Optional[SLO] = None,
                 busy_s: Optional[float] = None) -> ServingReport:
    """Percentile + SLO reduction over per-request arrays.

    ``tpot_s`` entries may be NaN for single-token requests (no decode
    phase); they are excluded from TPOT percentiles but still SLO-checked
    on TTFT alone."""
    ttft = np.asarray(ttft_s, np.float64)
    tpot = np.asarray(tpot_s, np.float64)
    has_tpot = np.isfinite(tpot)
    p50t, p99t = (np.percentile(ttft, (50.0, 99.0)) if ttft.size
                  else (math.nan, math.nan))
    p50d, p99d = (np.percentile(tpot[has_tpot], (50.0, 99.0))
                  if has_tpot.any() else (math.nan, math.nan))
    att = None
    if slo is not None and ttft.size:
        ok = ttft <= slo.ttft_s
        ok &= np.where(has_tpot, tpot <= slo.tpot_s, True)
        att = float(ok.mean())
    return ServingReport(
        technology=technology, n_requests=int(ttft.size),
        offered_load=offered_load, sim_time_s=float(sim_time_s),
        energy_j=float(energy_j), prefill_tokens=int(prefill_tokens),
        decode_tokens=int(decode_tokens),
        ttft_p50_s=float(p50t), ttft_p99_s=float(p99t),
        tpot_p50_s=float(p50d), tpot_p99_s=float(p99d),
        slo_attainment=att,
        utilization=(float(busy_s / sim_time_s)
                     if busy_s is not None and sim_time_s else None))
