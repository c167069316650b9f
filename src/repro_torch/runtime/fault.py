"""Fault tolerance: step watchdog (straggler detection) and a restartable
loop (the port's own copy of ``repro.runtime.fault``; pure Python).

The watchdog keeps an EWMA of step time and flags steps slower than
``threshold x`` the moving average, for an orchestrator to act on.  A
SIGTERM handler requests a final checkpoint, so a preemption resumes
losslessly.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional


class StepWatchdog:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.straggler_steps: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = dt > self.threshold * self.ewma
        if is_slow:
            self.straggler_steps.append(step)
        # slow steps do not poison the average
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.threshold * self.ewma)
        return is_slow


class FaultTolerantLoop:
    """Wraps a step function with checkpoint/resume and preemption
    handling."""

    def __init__(self, checkpointer, save_every: int = 100):
        self.ckpt = checkpointer
        self.save_every = save_every
        self.preempted = False
        self._old_handler = None
        self._installed = False

    def install_sigterm(self):
        def handler(signum, frame):
            self.preempted = True

        self._old_handler = signal.signal(signal.SIGTERM, handler)
        self._installed = True

    def uninstall_sigterm(self):
        """Restore the SIGTERM disposition that ``install_sigterm``
        replaced, so a finished loop does not leave the process's SIGTERM
        pointing at a flag nobody reads."""
        if self._installed:
            signal.signal(signal.SIGTERM, self._old_handler)
            self._old_handler = None
            self._installed = False

    def __enter__(self):
        self.install_sigterm()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.uninstall_sigterm()
        return False

    def run(
        self,
        state,
        step_fn: Callable,
        get_batch: Callable[[int], dict],
        start_step: int,
        total_steps: int,
        log: Callable[[int, dict, float], None] = lambda *a: None,
    ):
        watchdog = StepWatchdog()
        step = start_step
        while step < total_steps and not self.preempted:
            t0 = time.time()
            batch = get_batch(step)
            state, metrics = step_fn(state, batch)
            dt = time.time() - t0
            slow = watchdog.observe(step, dt)
            if slow:
                metrics = dict(metrics)
                metrics["straggler"] = True
            log(step, metrics, dt)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state)
        if self.preempted:
            self.ckpt.save(step, state, blocking=True)
        self.ckpt.wait()
        return state, step, watchdog
