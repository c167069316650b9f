"""Driver of the training traffic: the step of
``repro_torch.launch.steps.make_train_step`` (microbatch accumulation, the
WSD learning rate, clipped AdamW) on float32 parameters and moments with
the configuration's compute dtype, one step after another.

Set-up builds the step, the parameters (from the seed) and the moments,
and takes the first three steps through the window's own call and feed;
they are what the reference follows.  The window then runs steps until
``--seconds`` have passed and closes at the end of the step that passes
them.  Each step's batch is fresh: tokens of a Zipf law over the vocabulary
(the law of ``repro_torch.data.pipeline``'s synthetic source), drawn on the
card from the seed and the step.

Check, against the plain reference on the same weights and batches: the
loss of each of the three steps, each leaf's first gradient as the
optimizer takes it (the first moment after one step over 1 - b1) and each
leaf's change after the three steps.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from benchlib import weights
from benchlib.program import compared, program_arch
from benchlib.trace import span
from reference.model import Arch
from reference.precision import Precision
from reference.train import adamw, grads, leaves

F32 = torch.float32
FOLLOWED = 3            # steps the reference follows
EXCLUDE_BELOW = 1e-3    # leaves whose reference gradient is under this
                        # share of the median leaf's move by round-off only


def train_shape(run) -> dict:
    return run.config["train_4k"]


def batch_for(run, i: int) -> dict:
    """Step ``i``'s batch: tokens / labels (microbatches, rows, seq)."""
    t = train_shape(run)
    V = run.config["vocab_size"]
    mb = t["microbatches"]
    shape = (mb, t["global_batch"] // mb, t["seq_len"] + 1)
    gen = weights.generator(run.seed, 2 + i, run.device)
    u = torch.rand(shape, generator=gen, device=run.device, dtype=torch.float64)
    ranks = torch.floor(torch.exp(u * math.log(V))).to(torch.int64)
    toks = torch.clamp(V - ranks, 0, V - 1).to(torch.int32)
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}


def leaf_norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().to(F32)))
            for k, v in leaves(tree).items()}


def setup(run) -> None:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = program_arch(run)
    t = train_shape(run)
    o, s = t["optimizer"], t["schedule"]
    shape = ShapeConfig("train_4k", "train", t["seq_len"], t["global_batch"],
                        microbatches=t["microbatches"])
    step_fn = make_train_step(
        cfg, shape, AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"],
                                eps=o["eps"], weight_decay=o["weight_decay"],
                                clip_norm=o["clip_norm"]),
        total_steps=s["total"])
    params = weights.make_params(run.config, run.seed, run.device)
    m, v = adamw_init(params, cfg.opt_state_dtype)
    st = {"params": params, "m": m, "v": v, "step": s["first_step"],
          "fn": step_fn, "i": 0}
    run.state["program"] = st
    out = {"loss": [], "grad": None, "change": None}
    run.info["setup: process start to weights s"] = (time.perf_counter()
                                                     - run.t_process)
    for i in range(FOLLOWED):
        t0 = time.perf_counter()
        metrics = one_step(run)
        out["loss"].append(float(metrics["loss"]))
        run.info[f"setup: followed step {i + 1} s"] = time.perf_counter() - t0
        if i == 0:
            out["grad"] = {k: n / (1.0 - o["b1"])
                           for k, n in leaf_norms(st["m"]).items()}
    p0 = leaves(weights.make_params(run.config, run.seed, run.device))
    out["change"] = {k: float(torch.linalg.vector_norm(
        p.detach().to(F32) - p0[k])) for k, p in leaves(st["params"]).items()}
    del p0
    run.outputs = out


def one_step(run) -> dict:
    st = run.state["program"]
    batch = batch_for(run, st["i"])
    st["params"], st["m"], st["v"], st["step"], metrics = st["fn"](
        st["params"], st["m"], st["v"], st["step"], batch)
    st["i"] += 1
    return metrics


def window(run, seconds: float) -> None:
    t_open = time.perf_counter()
    run.attempted = run.failed = 0
    while True:
        t0 = time.perf_counter()
        with span("bench.step"):
            run.attempted += 1
            metrics = one_step(run)
            loss = float(metrics["loss"])
        t1 = time.perf_counter()
        run.failed += not math.isfinite(loss)
        run.records.append({"ms": 1e3 * (t1 - t0), "loss": loss})
        if t1 - t_open >= seconds:
            break


def end_to_end(run) -> dict:
    t = train_shape(run)
    n = len(run.records)
    run.info["steps"] = n
    run.info["step_ms_median"] = statistics.median(r["ms"] for r in run.records)
    return {"train_tokens_per_s": {
        "value": n * t["global_batch"] * t["seq_len"] / run.window_s,
        "unit": "tokens/s"}}


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def reference_outputs(run, prec: Precision) -> dict:
    """Loss of the first three steps, the first clipped gradient's and the
    three steps' change's norm per leaf, from the plain reference."""
    t = train_shape(run)
    arch = Arch(run.config)
    params = weights.make_params(run.config, run.seed, run.device)
    p0 = {k: p.clone() for k, p in leaves(params).items()}
    opt_state = {}
    out = {"loss": [], "grad": None, "grad_ref": None}
    for i in range(FOLLOWED):
        loss, g = grads(arch, params, batch_for(run, i), prec)
        clipped = adamw(params, opt_state, g, t["schedule"]["first_step"] + i,
                        t)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = {k: float(torch.linalg.vector_norm(c))
                           for k, c in clipped.items()}
        del g, clipped
    out["change"] = {k: float(torch.linalg.vector_norm(p - p0[k]))
                     for k, p in leaves(params).items()}
    return out


def leaf_gaps(got: dict, ref: dict, keys) -> dict:
    """Per leaf, the gap of the two norms over the reference's norm of the
    leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in keys}


def gaps(got: dict, ref: dict, info: dict) -> dict:
    med_g = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= EXCLUDE_BELOW * med_g]
    info["leaves left out of the change"] = sorted(set(ref["grad"]) - set(moving))
    grad = leaf_gaps(got["grad"], ref["grad"], list(ref["grad"]))
    change = leaf_gaps(got["change"], ref["change"], moving)
    info["worst grad leaf"] = max(grad, key=grad.get)
    info["worst change leaf"] = max(change, key=change.get)
    out = {f"loss_rel_gap.step{i + 1}": abs(a / b - 1.0)
           for i, (a, b) in enumerate(zip(got["loss"], ref["loss"]))}
    out.update(grad_norm_gap=max(grad.values()),
               change_norm_gap=max(change.values()),
               change_median_gap=statistics.median(change.values()))
    return out


def check(run) -> dict:
    ref = reference_outputs(run, Precision("stated"))
    return compared(run, gaps(run.outputs, ref, run.info))


def control_readings(run) -> dict:
    got = reference_outputs(run, Precision("control"))
    ref = reference_outputs(run, Precision("stated"))
    return gaps(got, ref, run.info)


def program_readings(run) -> dict:
    setup(run)
    run.state.clear()
    return gaps(run.outputs, reference_outputs(run, Precision("stated")),
                run.info)
