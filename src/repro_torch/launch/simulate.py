"""Simulated-clock serving: millions of requests priced in device time
(port of ``repro.launch.simulate``).

The scale path of the serving subsystem (DESIGN.md §11): replay a traffic
``Trace`` (``launch.traffic``) through the continuous-batching policy of
``launch.scheduler`` with every token priced by a technology's
``TokenPrices`` (``imc.cost_model``) — no model forwards, pure
bookkeeping — and return per-request TTFT / per-token latencies plus total
simulated time and energy.

Two interchangeable methods:

* ``events`` (default) — the fast path.  Between scheduler events
  (admission waves, completions, drain-to-arrival jumps) a decode segment's
  cost is integrated in closed form: per-token cost is affine in context
  position, so ``k`` steps over ``L`` live slots with position sum ``S``
  cost exactly ``k*L*t_tok + t_pos*(k*S + L*k*(k-1)/2)``.  One Python
  iteration per *event* (~2 per request) instead of per token — this is
  what serves 1e6+ Poisson requests per technology in the full benchmark.
* ``steps`` — the reference path: drives the **real**
  ``ContinuousBatchScheduler`` with a ``StubEngine`` one step at a time,
  pricing each step individually.  Token-for-token the same policy; the
  equivalence test pins ``events`` against it so the closed forms can never
  drift from the scheduler's actual semantics.

Policy (both methods, identical to the serve loop): FIFO admission into
idle slots, whole-batch re-prefill on join (recompute policy), joins only
at wave boundaries — a slot must free with arrived work waiting, or the
system must drain to the next arrival, before a new wave starts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.launch.scheduler import ContinuousBatchScheduler, Request
from repro_torch.launch.traffic import Trace


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Raw per-request outcome of one simulated serving run."""

    technology: str
    ttft_s: np.ndarray          # first-token latency per request [s]
    tpot_s: np.ndarray          # mean per-output-token latency (NaN if 1 tok)
    finish_s: np.ndarray        # completion clock per request [s]
    sim_time_s: float           # clock at last completion
    busy_s: float               # device time actually charged (no idle gaps)
    energy_j: float
    prefill_tokens: int
    decode_tokens: int
    waves: int                  # prefill waves (joins included)
    wave_tokens: int            # history tokens reprocessed across all waves


def _tpot(trace: Trace, ttft: np.ndarray, finish: np.ndarray) -> np.ndarray:
    olen = trace.output_tokens.astype(np.float64)
    first = trace.arrival_s + ttft
    with np.errstate(invalid="ignore", divide="ignore"):
        tpot = (finish - first) / (olen - 1.0)
    return np.where(olen > 1.0, tpot, np.nan)


def _simulate_events(prices, trace: Trace, n_slots: int) -> SimResult:
    n = len(trace)
    arr = trace.arrival_s.tolist()
    plen = trace.prompt_tokens.tolist()
    olen = trace.output_tokens.tolist()
    t_tok, t_pos = prices.t_tok, prices.t_pos
    e_tok, e_pos = prices.e_tok, prices.e_pos

    ttft = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    slot_rid = [-1] * n_slots
    slot_pos = [0] * n_slots        # history length (prompt + generated)
    slot_rem = [0] * n_slots        # tokens still to produce
    slot_first = [False] * n_slots  # next committed token is the first one
    clock = busy = energy = 0.0
    nxt = completed = 0
    waves = wave_tokens = decode_tokens = 0

    while completed < n:
        live = [s for s in range(n_slots) if slot_rid[s] >= 0]
        if not live:
            if nxt >= n:
                break
            clock = max(clock, arr[nxt])
        # ---- admission: fill idle slots FIFO with arrived requests -------
        for s in range(n_slots):
            if slot_rid[s] < 0 and nxt < n and arr[nxt] <= clock:
                slot_rid[s], slot_pos[s] = nxt, plen[nxt]
                slot_rem[s], slot_first[s] = olen[nxt], True
                nxt += 1
        live = [s for s in range(n_slots) if slot_rid[s] >= 0]
        # ---- prefill wave: recompute every live history ------------------
        waves += 1
        tw = ew = 0.0
        for s in live:
            h = slot_pos[s]
            tri = h * (h - 1) / 2.0
            tw += h * t_tok + t_pos * tri
            ew += h * e_tok + e_pos * tri
            wave_tokens += h
        clock += tw
        busy += tw
        energy += ew
        # wave commit: one token per live slot
        freed = False
        for s in live:
            slot_pos[s] += 1
            slot_rem[s] -= 1
            if slot_first[s]:
                slot_first[s] = False
                ttft[slot_rid[s]] = clock - arr[slot_rid[s]]
            else:
                decode_tokens += 1
            if slot_rem[s] == 0:
                finish[slot_rid[s]] = clock
                slot_rid[s] = -1
                completed += 1
                freed = True
        if completed >= n:
            break
        if freed and nxt < n and arr[nxt] <= clock:
            continue                          # re-join at the wave boundary
        # ---- decode segments: closed-form between events -----------------
        while True:
            live = [s for s in range(n_slots) if slot_rid[s] >= 0]
            if not live:
                break                         # drain -> next arrival (outer)
            k = min(slot_rem[s] for s in live)
            ln = len(live)
            ssum = sum(slot_pos[s] for s in live)
            steps = k * ssum + ln * k * (k - 1) / 2.0
            dt = k * ln * t_tok + t_pos * steps
            clock += dt
            busy += dt
            energy += k * ln * e_tok + e_pos * steps
            decode_tokens += k * ln
            freed = False
            for s in live:
                slot_pos[s] += k
                slot_rem[s] -= k
                if slot_rem[s] == 0:
                    finish[slot_rid[s]] = clock
                    slot_rid[s] = -1
                    completed += 1
                    freed = True
            if completed >= n:
                break
            if freed and nxt < n and arr[nxt] <= clock:
                break                         # -> admission wave
    return SimResult(prices.technology, ttft, _tpot(trace, ttft, finish),
                     finish, clock, busy, energy, n, decode_tokens, waves,
                     wave_tokens)


def _simulate_steps(prices, trace: Trace, n_slots: int,
                    engine=None) -> SimResult:
    """Reference path: the real scheduler + a stub engine, step by step."""
    from repro_torch.launch.engine import StubEngine

    n = len(trace)
    engine = engine or StubEngine()
    sched = ContinuousBatchScheduler(n_slots=n_slots, max_new=1)
    for rid in range(n):
        sched.submit(Request(rid=rid,
                             prompt=np.zeros(int(trace.prompt_tokens[rid]),
                                             np.int32),
                             arrival=float(trace.arrival_s[rid]),
                             max_new=int(trace.output_tokens[rid])))
    ttft = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    clock = busy = energy = 0.0
    wave_tokens = 0

    while not sched.finished:
        if not sched.live and not sched.has_waiting(clock):
            clock = max(clock, sched.next_arrival())
        sched.admit(clock)
        hist_lens = sched.positions()
        wave_tokens += sum(hist_lens)
        for h in hist_lens:
            c = prices.prefill(h)
            clock += c.t
            busy += c.t
            energy += c.e
        tok, _ = engine.prefill(sched.histories(), sched.frontends())
        while True:
            out = sched.commit(tok, clock)
            for rid in out.first_tokens:
                ttft[rid] = clock - trace.arrival_s[rid]
            for rid in out.finished:
                finish[rid] = clock
            # leave the wave when done, when the system drains (remaining
            # arrivals are in the future -- the outer loop jumps the clock),
            # or when a freed slot has arrived work to join
            if sched.finished or not sched.live or (
                    out.freed and sched.has_waiting(clock)):
                break
            pos = sched.slot_positions()
            for p in pos:
                if p > 0:
                    c = prices.decode_token(p)
                    clock += c.t
                    busy += c.t
                    energy += c.e
            tok, _ = engine.decode_step(tok, pos)
    return SimResult(prices.technology, ttft, _tpot(trace, ttft, finish),
                     finish, clock, busy, energy, sched.prefill_tokens,
                     sched.decode_tokens, sched.waves, wave_tokens)


def simulate_serving(prices, trace: Trace, n_slots: int = 8,
                     method: str = "events",
                     engine=None) -> SimResult:
    """Serve ``trace`` on ``n_slots`` slots under ``prices``.

    ``method='events'`` is the closed-form fast path; ``method='steps'``
    drives the real scheduler one step at a time (small traces / tests).
    """
    if method == "events":
        return _simulate_events(prices, trace, n_slots)
    if method == "steps":
        return _simulate_steps(prices, trace, n_slots, engine=engine)
    raise ValueError(f"unknown method {method!r}; 'events' or 'steps'")


# --- graceful degradation: SLO attainment vs hard-fault rate ----------------

@dataclasses.dataclass(frozen=True)
class FaultSLOPoint:
    """One (repair policy, fault rate) cell of the serving degradation
    curve (DESIGN.md §13): the *healthy* device's trace and SLO served at
    the faulty device's token prices."""

    technology: str
    fault_rate: float
    repair: str                  # policy name ("none" when unrepaired)
    slo_attainment: float
    array_yield: float
    ttft_p99_s: float
    tpot_p99_s: float
    tokens_per_joule: float


def fault_slo_curve(kind: str = "afmtj",
                    rates=(0.0, 1e-3, 3e-3, 1e-2),
                    policies=(None,), *, arch: str = "qwen2-0.5b",
                    rho: float = 0.7, n_requests: int = 2000,
                    n_slots: int = 8, seed: int = 0, device=None) -> list:
    """Serving SLO attainment vs fault rate × repair policy.

    The offered load, the Poisson trace, and the SLO are all fixed at the
    *healthy* device's prices — the question is how much of the committed
    service level a degrading part can still honor, not how a re-provisioned
    system would behave.  Each (policy, rate) point then re-prices the SAME
    trace with the fault-charged cost model (``imc_cost_model(faults=...)``:
    repair-yield latency stretch + ECC/spare energy overhead) and replays it
    through the event-driven simulator.  Rate 0 is bit-identical to the
    healthy run for every policy (``fault_cost_factors`` is (1,1,1) when no
    fault plane is active), so each curve starts at the same attainment.
    The hierarchy's device solves run on ``device`` (None = CUDA).
    """
    from repro_torch.configs.registry import ARCHS
    from repro_torch.imc.cost_model import device_cost_model, per_token_counts
    from repro_torch.imc.faults import FaultSpec
    from repro_torch.launch.report import SLO, build_report
    from repro_torch.launch.traffic import (CHAT_OUTPUTS, CHAT_PROMPTS,
                                            poisson_at_load)

    tc = per_token_counts(ARCHS[arch])
    healthy = device_cost_model(kind, device=device).token_prices(tc)
    trace = poisson_at_load(healthy, rho, n_requests, n_slots,
                            seed=seed).trace()
    slo = SLO.normalized(healthy, CHAT_PROMPTS, CHAT_OUTPUTS, n_slots)
    points = []
    for pol in policies:
        for r in rates:
            spec = FaultSpec.at_rate(float(r), seed=seed)
            model = device_cost_model(kind, faults=spec, repair=pol,
                                      device=device)
            res = simulate_serving(model.token_prices(tc), trace,
                                   n_slots=n_slots)
            rep = build_report(kind, res.ttft_s, res.tpot_s, res.sim_time_s,
                               res.energy_j, res.prefill_tokens,
                               res.decode_tokens, offered_load=rho, slo=slo,
                               busy_s=res.busy_s)
            points.append(FaultSLOPoint(
                technology=kind, fault_rate=float(r),
                repair="none" if pol is None else pol.name,
                slo_attainment=float(rep.slo_attainment),
                array_yield=float(model.array_yield),
                ttft_p99_s=rep.ttft_p99_s, tpot_p99_s=rep.tpot_p99_s,
                tokens_per_joule=rep.tokens_per_joule))
    return points
