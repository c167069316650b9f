"""Serving CLI: wiring for the engine / scheduler / cost-model stack
(port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 16``

The module is thin (DESIGN.md §11): it parses arguments and wires the
serving layers together —

* ``launch.engine.ServeEngine`` — parameters, fixed-window prefill and
  single-token decode with a KV cache, on the card (``--device``); returns
  next tokens plus per-step op counts,
* ``launch.scheduler.ContinuousBatchScheduler`` — slots, queue, FIFO
  admission with the prefill-on-join recompute policy, token accounting,
* ``imc.cost_model.DeviceCostModel`` — prices every step's op counts in
  simulated AFMTJ / MTJ / CPU time and energy: the serving clock.

``serve`` is the loop itself for any config and engine (``chip_smoke.py``
drives it at full width); ``main`` runs it on the arch's smoke config and
returns the stats dict: the scheduler's accounting (served counts,
prefill / decode token split, per-request completions) plus a ``device``
map of per-technology simulated-clock reports.  For load studies over
millions of requests use ``launch.simulate`` (no model forwards).
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np

from repro_torch.configs.registry import smoke_config
from repro_torch.imc.cost_model import TECHNOLOGIES, device_cost_model
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.report import build_report
from repro_torch.launch.scheduler import ContinuousBatchScheduler, Request


def serve(cfg, engine, n_requests: int, batch: int, prompt_len: int,
          max_new: int, eos_id: int = -1,
          technologies: Sequence[str] = TECHNOLOGIES, device=None,
          log=print) -> dict:
    """Serve ``n_requests`` prompts of ``prompt_len`` tokens (drawn from
    ``np.random.default_rng(0)``) through ``engine`` on ``batch`` slots,
    charging every step to each technology's simulated clock (the cost
    models' device solves on ``device``)."""
    sched = ContinuousBatchScheduler(batch, max_new, eos_id=eos_id)
    rng = np.random.default_rng(0)
    for rid in range(n_requests):
        sched.submit(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab, prompt_len).astype(np.int32),
            frontend=engine.draw_frontend(rng)))

    techs = list(technologies)
    models = {t: device_cost_model(t, device=device) for t in techs}
    clock = {t: 0.0 for t in techs}
    energy = {t: 0.0 for t in techs}
    ttft = {t: np.full(n_requests, np.nan) for t in techs}
    finish = {t: np.full(n_requests, np.nan) for t in techs}

    def charge(counts):
        for t in techs:
            c = models[t].step_cost(counts)
            clock[t] += c.t
            energy[t] += c.e

    t0 = time.perf_counter()
    while not sched.finished:
        sched.admit()
        tok, counts = engine.prefill(sched.histories(), sched.frontends())
        charge(counts)
        while True:
            out = sched.commit(tok)
            for t in techs:
                for rid in out.first_tokens:
                    ttft[t][rid] = clock[t]
                for rid in out.finished:
                    finish[t][rid] = clock[t]
            if sched.finished or (out.freed and sched.has_waiting()):
                break
            tok, counts = engine.decode_step(tok, sched.slot_positions())
            charge(counts)
        log(f"served {sched.served}/{n_requests} requests "
            f"({sched.prefill_tokens} prefill + {sched.decode_tokens} "
            f"decode tokens, {sched.waves} prefill waves)")
    dt = time.perf_counter() - t0

    stats = sched.stats()
    stats["elapsed_s"] = dt
    olen = np.array([len(c) for c in stats["completions"]], np.float64)
    stats["device"] = {}
    for t in techs:
        with np.errstate(invalid="ignore", divide="ignore"):
            tpot = np.where(olen > 1.0,
                            (finish[t] - ttft[t]) / np.maximum(olen - 1.0,
                                                               1.0),
                            np.nan)
        rep = build_report(t, ttft[t], tpot, clock[t], energy[t],
                           stats["prefill_tokens"], stats["decode_tokens"])
        stats["device"][t] = rep.row_dict()
        log(f"[{t}] simulated {clock[t]:.3e} s, {energy[t]:.3e} J, "
            f"p99 TTFT {rep.ttft_p99_s:.3e} s, "
            f"p99 TPOT {rep.tpot_p99_s:.3e} s")
    if stats["generated_tokens"] and dt > 0:
        log(f"wall throughput: {stats['generated_tokens'] / dt:.1f} tok/s "
            f"({cfg.name} on {engine.device}; device numbers above are "
            f"simulated)")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="token id that finishes a sequence (-1: disabled)")
    ap.add_argument("--technologies", default=",".join(TECHNOLOGIES),
                    help="comma list of device clocks to charge "
                         f"(default: {','.join(TECHNOLOGIES)})")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the hierarchy's "
                         "device solves (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    engine = ServeEngine(cfg, args.prompt_len, args.max_new, args.batch,
                         device=args.device)
    techs = [t for t in args.technologies.split(",") if t]
    return serve(cfg, engine, args.requests, args.batch, args.prompt_len,
                 args.max_new, eos_id=args.eos_id, technologies=techs,
                 device=args.device)


if __name__ == "__main__":
    main()
