"""Continuous-batching scheduler: slots, queue, admission (the port's own
copy of ``repro.launch.scheduler``; numpy only).

``ContinuousBatchScheduler`` owns the request queue, the decode slots, and
the per-request accounting that used to live inline in ``launch/serve.py``
(DESIGN.md §11).  It is pure Python/numpy so every admission edge case is
unit-testable without a model: the engine (real or stub) only turns
histories into next tokens.

Admission policy: *prefill-on-join recompute* (the one pluggable policy
hook): idle slots are filled FIFO from the
arrived queue, then the **whole** live batch is re-prefilled as one wave —
every live slot's next token comes from that wave, and joins happen only at
wave boundaries (a slot must free with work waiting, or the system must
drain, before the next wave).  The serve loop is::

    while not sched.finished:
        sched.admit(now)                       # fill idle slots (FIFO)
        tok = engine.prefill(sched.histories(), sched.frontends())
        while True:
            out = sched.commit(tok, now)       # append + count + free slots
            if sched.finished or (out.freed and sched.has_waiting(now)):
                break
            tok = engine.decode_step(tok, sched.positions())

Token accounting is split at commit time: a request's **first** generated
token is produced by the prefill wave (``prefill_tokens``); everything after
is a decode token (``decode_tokens``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request.  ``prompt`` is the token array (or any sized
    sequence — the stub engine only needs its length); ``max_new`` caps the
    generated tokens (falls back to the scheduler default); ``frontend`` is
    per-request conditioning drawn once at admission time by the caller."""

    rid: int
    prompt: np.ndarray
    arrival: float = 0.0
    max_new: Optional[int] = None
    frontend: Any = None


@dataclasses.dataclass(frozen=True)
class CommitOutcome:
    freed: bool                      # did any slot free this step?
    finished: List[int]              # rids completed this step
    first_tokens: List[int]          # rids whose FIRST token just committed


class ContinuousBatchScheduler:
    """Slot/queue state machine for continuous batching."""

    def __init__(self, n_slots: int, max_new: int, eos_id: int = -1):
        assert n_slots >= 1
        self.n_slots = n_slots
        self.max_new = max_new
        self.eos_id = eos_id
        self.queue: collections.deque[Request] = collections.deque()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_hist: List[np.ndarray] = [np.zeros(0, np.int32)] * n_slots
        self.slot_gen: List[int] = [0] * n_slots
        # accounting
        self.submitted = 0
        self.served = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.waves = 0                      # prefill waves (joins included)
        self.completions: Dict[int, List[int]] = {}
        self.admission_order: List[int] = []

    # ---- queue -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """FIFO enqueue.  Requests must be submitted in arrival order."""
        if self.queue and req.arrival < self.queue[-1].arrival:
            raise ValueError("submit() out of arrival order")
        self.queue.append(req)
        self.submitted += 1

    def has_waiting(self, now: float = math.inf) -> bool:
        """Is an *arrived* request waiting for a slot?"""
        return bool(self.queue) and self.queue[0].arrival <= now

    def next_arrival(self) -> Optional[float]:
        return self.queue[0].arrival if self.queue else None

    @property
    def live(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.slot_req[s] is not None]

    @property
    def finished(self) -> bool:
        return not self.queue and not self.live

    # ---- admission (the prefill-on-join policy) --------------------------
    def admit(self, now: float = math.inf) -> List[int]:
        """Fill idle slots FIFO from the arrived queue; returns the slots
        that joined.  The caller must follow any non-empty join with a
        prefill wave over ``histories()`` (`commit(..., wave start)` counts
        it)."""
        joined = []
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.has_waiting(now):
                req = self.queue.popleft()
                self.slot_req[s] = req
                self.slot_hist[s] = np.asarray(req.prompt, np.int32)
                self.slot_gen[s] = 0
                self.admission_order.append(req.rid)
                joined.append(s)
        if joined:
            self.waves += 1
        return joined

    # ---- batch views for the engine --------------------------------------
    def histories(self) -> List[np.ndarray]:
        """Per-slot token history (prompt + generated); empty for idle."""
        return [self.slot_hist[s] if self.slot_req[s] is not None
                else np.zeros(0, np.int32) for s in range(self.n_slots)]

    def frontends(self) -> List[Any]:
        return [r.frontend if r is not None else None for r in self.slot_req]

    def positions(self) -> List[int]:
        """Live slots' history lengths (decode-step attention spans)."""
        return [len(self.slot_hist[s]) for s in self.live]

    def slot_positions(self) -> List[int]:
        """Per-slot history lengths, 0 for idle slots (engine decode view)."""
        return [len(self.slot_hist[s]) if self.slot_req[s] is not None else 0
                for s in range(self.n_slots)]

    # ---- token commit ----------------------------------------------------
    def commit(self, tokens: Sequence[int], now: float = 0.0) -> CommitOutcome:
        """Commit one wave/step's next token per live slot: append to the
        history, split the prefill/decode count, and free finished slots
        (EOS or the request's ``max_new`` cap — both checked on the same
        step, completing exactly once)."""
        tok = np.asarray(tokens)
        freed, finished, first = False, [], []
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is None:
                continue                      # dead slot: not counted
            t = int(tok[s])
            self.slot_hist[s] = np.append(self.slot_hist[s], np.int32(t))
            self.slot_gen[s] += 1
            if self.slot_gen[s] == 1:         # produced by the prefill wave
                self.prefill_tokens += 1
                first.append(req.rid)
            else:
                self.decode_tokens += 1
            cap = req.max_new if req.max_new is not None else self.max_new
            if t == self.eos_id or self.slot_gen[s] >= cap:
                self.completions[req.rid] = (
                    self.slot_hist[s][-self.slot_gen[s]:].tolist())
                finished.append(req.rid)
                self.slot_req[s] = None
                self.served += 1
                freed = True
        return CommitOutcome(freed=freed, finished=finished,
                             first_tokens=first)

    # ---- stats -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "served": self.served,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "generated_tokens": self.prefill_tokens + self.decode_tokens,
            "prefills": self.waves,
            "completions": [self.completions[r]
                            for r in sorted(self.completions)],
        }
