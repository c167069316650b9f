"""Driver of the model-accuracy surface traffic: one client, no think
time, each request one ``repro_torch.imc.model_analog.model_accuracy``
call (an analog forward of every linear through the fake-analog kernel,
scored against the exact logits), all points sharing one set-up state as
``model_accuracy_surface`` shares it.

The mix file gives the batch, the sequence length and the point axes; the
points cycle in product order from ``seed mod n``.  The window closes at
the end of the first point that ends ``--seconds`` after it opened (and
not before the sampled points below have run, which are among its first
four), so every point in it is whole and the window's time is all of
theirs.

Check: the exact logits of the set-up (every position) and, for a sample
of points drawn from the seed (one per process corner), everything the
analog forward produced at a sample of positions, each against the plain
reference run on the same weights and tokens once the window has closed:
the analog logits; every crossbar product, recomputed from the input the
program gave it; the forward between the crossbars (norms, the
attention's core, the FFN's gate, the whole mixture of experts), followed
layer by layer from the program's crossbar outputs; and the reported KL,
perplexities and token match.

The program's side is read through ``model_analog.model_forward_logits``,
whose ``hook(x2d, w, tag)`` the analog forward passes in: the benchmark
wraps that hook, and reads each product's input and output by its tag
and the tag's count (the layer).
"""
from __future__ import annotations

import itertools
import math
import random
import statistics
import time

import torch

from benchlib import weights
from benchlib.program import compared, program_arch
from benchlib.trace import span
from reference.analog import analog_product
from reference.model import Arch, Model, site_weight, sites
from reference.precision import Precision
from reference.scoring import kl_rows, point_scores

F32 = torch.float32
# crossbar outputs kept whole: the attention's core reads every position of
# q, k and v, and wo's and w_down's are added to the residual stream; of
# the others only the sampled positions are kept
WHOLE = ("wq", "wk", "wv", "wo", "w_down")
CHAIN_OFF = 1e-2        # a row whose chain gap passes this is counted off


# ---------------------------------------------------------------------------
# the traffic
# ---------------------------------------------------------------------------
def points(traffic: dict) -> list:
    ax = traffic["points"]
    return [dict(adc_bits=b, tmr=t, corner=c, write_ber=w)
            for b, t, c, w in itertools.product(
                ax["adc_bits"], ax["tmr"], ax["corner"], ax["write_ber"])]


def analog_seed(seed: int) -> int:
    return int(seed) & 0x7FFFFFFF


def sample(run) -> tuple:
    """(sampled point indices, sampled positions), drawn from the seed: for
    each corner one of its first two points in the window's cycle order (so
    a window of four points holds them), and ``sample_rows`` positions of
    the batch."""
    rng = random.Random(run.seed)
    pts = points(run.traffic)
    order = [(run.seed + i) % len(pts) for i in range(len(pts))]
    chosen = []
    for corner in run.traffic["points"]["corner"]:
        first = [k for k in order if pts[k]["corner"] == corner][:2]
        chosen.append(rng.choice(first))
    n = run.traffic["batch"] * run.traffic["seq_len"]
    rows = sorted(rng.sample(range(n), min(n, run.traffic["sample_rows"])))
    return sorted(chosen), rows


def tokens_for(run) -> torch.Tensor:
    gen = weights.generator(run.seed, 1, run.device)
    return torch.randint(0, run.config["vocab_size"],
                         (run.traffic["batch"], run.traffic["seq_len"]),
                         generator=gen, device=run.device)


# ---------------------------------------------------------------------------
# set-up, window, end-to-end numbers
# ---------------------------------------------------------------------------
def setup(run) -> None:
    from repro_torch.imc import model_analog as ma

    t0 = time.perf_counter()
    cfg = program_arch(run)
    params = weights.make_params(run.config, run.seed, run.device)
    tokens = tokens_for(run)
    t1 = time.perf_counter()
    exact = ma.model_forward_logits(params, cfg, tokens)
    t2 = time.perf_counter()
    run.info["setup: process start to weights s"] = t1 - run.t_process
    run.info["setup: exact forward s"] = t2 - t1
    run.state["program"] = (cfg, params, tokens, exact)
    run.outputs = {"exact": exact, "analog": {}, "sites": {}}
    run.sampled, run.rows = sample(run)
    run.capture_for = None
    install_capture(run, ma)
    pts = points(run.traffic)
    run.start = run.seed % len(pts)
    # one point of each kernel instance the cycle launches, through the
    # window's own call
    warmed = set()
    for i in range(len(pts)):
        p = pts[(run.start + i) % len(pts)]
        key = (p["corner"] != "tt", p["write_ber"] > 0.0)
        if key not in warmed:
            warmed.add(key)
            t0 = time.perf_counter()
            one_point(run, p)
            run.info[f"setup: warm point {p} s"] = time.perf_counter() - t0


class Kept:
    """The crossbar products of one forward, by (tag, layer): the input
    whole (one copy where consecutive products share it, as q, k and v
    do), the output whole for the tags in ``WHOLE`` and at ``rows`` for the
    others, none for the unembed (its output is the logits)."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.sites = {}
        self.count = {}
        self.last = (None, None)

    def keep(self, x2, y, tag: str) -> None:
        layer = self.count.get(tag, 0)
        self.count[tag] = layer + 1
        src, copy = self.last
        if not (src is not None and x2.data_ptr() == src.data_ptr()
                and x2.shape == src.shape and x2.dtype == src.dtype):
            copy = x2.clone()
            self.last = (x2, copy)
        whole = tag in WHOLE
        out = (None if tag == "unembed" else y.clone() if whole
               else y.reshape(-1, y.shape[-1])[self.rows].clone())
        self.sites[(tag, layer)] = {"x": copy, "y": out, "rows": not whole}


def install_capture(run, ma) -> None:
    """Wrap the program's ``model_forward_logits``: while
    ``run.capture_for`` names a sampled point, a forward that runs with a
    linear hook (the analog forward) keeps the logits it returns and,
    through the hook, every crossbar product (``Kept``)."""
    forward = ma.model_forward_logits
    rows = torch.tensor(run.rows, device=run.device)

    def capturing(params, cfg, tokens, hook=None):
        k = run.capture_for
        if hook is None or k is None:
            return forward(params, cfg, tokens, hook)
        kept = Kept(rows)

        def keep(x2, w, tag):
            y = hook(x2, w, tag)
            kept.keep(x2, y, tag)
            return y

        logits = forward(params, cfg, tokens, keep)
        run.outputs["sites"][k] = kept.sites
        run.outputs["analog"][k] = logits
        return logits

    def restore():
        ma.model_forward_logits = forward

    ma.model_forward_logits = capturing
    run.restore = restore


def one_point(run, p: dict):
    from repro_torch.imc import model_analog as ma
    from repro_torch.imc.analog_pipeline import AnalogConfig

    acfg = AnalogConfig(adc_bits=p["adc_bits"], tmr=p["tmr"],
                        write_ber=p["write_ber"], seed=analog_seed(run.seed))
    return ma.model_accuracy(
        run.config["program_arch"], acfg, kind=run.traffic["kind"],
        mode=run.traffic["mode"], corner=p["corner"],
        batch=run.traffic["batch"], seq_len=run.traffic["seq_len"],
        seed=run.seed, smoke=False, device=run.device,
        _setup_state=run.state["program"])


def window(run, seconds: float) -> None:
    pts = points(run.traffic)
    t_open = time.perf_counter()
    i = run.start
    run.attempted = run.failed = 0
    tried = set()
    while True:
        k = i % len(pts)
        first = k in run.sampled and k not in tried
        tried.add(k)
        run.capture_for = k if first else None
        t0 = time.perf_counter()
        with span("bench.point"):
            run.attempted += 1
            rep = one_point(run, pts[k])
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
        t1 = time.perf_counter()
        ok = all(math.isfinite(v) for v in (rep.kl, rep.token_match,
                                           rep.ppl_analog, rep.ppl_ref))
        run.failed += not ok
        run.records.append({"point": k, "ms": 1e3 * (t1 - t0),
                            "report": rep})
        i += 1
        if t1 - t_open >= seconds and set(run.sampled) <= tried:
            break
    run.capture_for = None
    run.restore()


def tokens_per_point(run) -> int:
    return run.traffic["batch"] * run.traffic["seq_len"]


def end_to_end(run) -> dict:
    ms = [r["ms"] for r in run.records]
    n = len(ms)
    rate = n * tokens_per_point(run) / run.window_s
    tail = statistics.quantiles(ms, n=100, method="inclusive")[
        run.traffic["tail_percentile"] - 1] if n > 1 else ms[0]
    run.info["points"] = n
    run.info["point_ms_median"] = statistics.median(ms)
    return {"surface_tokens_per_s": {"value": rate, "unit": "tokens/s"},
            f"point_ms_p{run.traffic['tail_percentile']}":
                {"value": tail, "unit": "ms"}}


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def reference_outputs(run, prec: Precision, capture: bool = False) -> dict:
    """What the window produced, computed by the plain reference at
    ``prec`` from the same weights and tokens: the exact logits and, per
    sampled point, the analog logits and the point's scores; with
    ``capture``, also the crossbar products of each analog forward as the
    program's are kept."""
    params = weights.make_params(run.config, run.seed, run.device)
    tokens = tokens_for(run)
    arch = Arch(run.config)
    rows = torch.tensor(run.rows, device=run.device)
    exact = Model(arch, params, prec).forward_logits(tokens)
    pts = points(run.traffic)
    out = {"exact": exact, "analog": {}, "scores": {}, "sites": {}}
    for k in run.sampled:
        p = dict(pts[k], seed=analog_seed(run.seed))
        kept = Kept(rows)

        def hook(x2, w, tag, p=p, kept=kept):
            y = analog_product(x2, w, run.config["analog"], p, prec)
            if capture:
                kept.keep(x2, y, tag)
            return y

        ana = Model(arch, params, prec, linear_hook=hook).forward_logits(
            tokens)
        out["analog"][k] = ana
        out["scores"][k] = point_scores(exact, ana, tokens)
        out["sites"][k] = kept.sites
    return out


def site_readings(run, got: dict) -> dict:
    """The crossbar products and the forward between them, judged at the
    stated precision from what ``got`` kept: each product recomputed by the
    reference from its kept input (share of sampled outputs whose ADC code
    differs, largest gap in codes), and the forward followed layer by layer
    from the kept products (``Model.teacher_forced``: of each crossbar
    input, the median and the 90th percentile of the row gaps, and the
    share of rows off by more than ``CHAIN_OFF``; each the largest over
    the inputs and the sampled points)."""
    params = weights.make_params(run.config, run.seed, run.device)
    tokens = tokens_for(run)
    arch = Arch(run.config)
    stated = Precision("stated")
    rows = torch.tensor(run.rows, device=run.device)
    pts = points(run.traffic)
    out = dict(analog_code_share=0.0, analog_code_gap=0.0,
               chain_gap_median=0.0, chain_gap_p90=0.0, chain_rows_off=0.0)
    worst = ""
    for k in run.sampled:
        p = dict(pts[k], seed=analog_seed(run.seed))
        kept = got["sites"][k]
        for site, v in kept.items():
            x = v["x"]
            y_ref, step = analog_product(
                x, site_weight(arch, params, site).to(x.dtype),
                run.config["analog"], p, stated, with_step=True)
            y_ref = y_ref[rows]
            y = got["analog"][k] if v["y"] is None else v["y"]
            if v["y"] is None or not v["rows"]:
                y = y.reshape(-1, y_ref.shape[-1])[rows]
            d = torch.abs(y.to(F32) - y_ref) / step
            del y_ref
            out["analog_code_share"] = max(out["analog_code_share"], float(
                torch.mean((d > 0.5).to(F32))))
            out["analog_code_gap"] = max(out["analog_code_gap"],
                                         float(torch.max(d)))
        model = Model(arch, params, stated)
        for what, layer, g in model.teacher_forced(tokens, kept, rows):
            q = torch.quantile(g, torch.tensor([0.5, 0.9], device=g.device))
            off = float(torch.mean((g > CHAIN_OFF).to(F32)))
            if float(q[1]) > out["chain_gap_p90"]:
                worst = f"{what} of layer {layer} at point {k}"
            out["chain_gap_median"] = max(out["chain_gap_median"],
                                          float(q[0]))
            out["chain_gap_p90"] = max(out["chain_gap_p90"], float(q[1]))
            out["chain_rows_off"] = max(out["chain_rows_off"], off)
    run.info["chain: widest 90th percentile"] = worst
    return out


def program_outputs(run) -> dict:
    tokens = tokens_for(run)
    scores = {}
    for r in run.records:
        if r["point"] in run.sampled and r["point"] not in scores:
            rep = r["report"]
            scores[r["point"]] = (rep.kl, rep.token_match, rep.ppl_analog,
                                  rep.ppl_ref)
    judged = {k: point_scores(run.outputs["exact"], a, tokens)
              for k, a in run.outputs["analog"].items()}
    return {"exact": run.outputs["exact"], "analog": run.outputs["analog"],
            "scores": scores, "judged": judged,
            "sites": run.outputs["sites"]}


def gaps(run, got: dict, ref: dict) -> dict:
    """Every number the check can compare: ``got`` (the program's outputs,
    or the control's) against the reference's."""
    every = set(sites(Arch(run.config)))
    missing = sum(len(every - set(got["sites"].get(k, {})))
                  + (k not in got["analog"]) + (k not in got["scores"])
                  for k in run.sampled)
    out = {"missing_outputs": float(missing),
           "exact_logit_kl": float(torch.mean(kl_rows(ref["exact"],
                                                      got["exact"])))}
    if missing:
        return out
    rows = torch.tensor(run.rows, device=run.device)
    analog_kl = kl_rel = ppl_rel = match = 0.0
    for k in run.sampled:
        a_ref = ref["analog"][k].reshape(-1, ref["analog"][k].shape[-1])
        a_got = got["analog"][k].reshape(a_ref.shape)
        analog_kl = max(analog_kl, float(torch.mean(
            kl_rows(a_ref[rows], a_got[rows]))))
        kl_p, match_p, ppl_a_p, ppl_r_p = got["scores"][k]
        kl_j, match_j, ppl_a_j, ppl_r_j = got["judged"][k]
        kl_rel = max(kl_rel, abs(kl_p / kl_j - 1.0))
        ppl_rel = max(ppl_rel, abs(ppl_a_p / ppl_a_j - 1.0),
                      abs(ppl_r_p / ppl_r_j - 1.0))
        match = max(match, abs(match_p - match_j))
    out.update(analog_logit_kl=analog_kl, score_kl_rel_gap=kl_rel,
               score_ppl_rel_gap=ppl_rel, score_match_gap=match)
    out.update(site_readings(run, got))
    return out


def check(run) -> dict:
    got = program_outputs(run)
    return compared(run, gaps(run, got, reference_outputs(
        run, Precision("stated"))))


def control_readings(run) -> dict:
    """The control: the reference put in the program's place at the
    precision below the stated one, its crossbar products kept as the
    program's are, compared as the program is."""
    run.sampled, run.rows = sample(run)
    ctl = reference_outputs(run, Precision("control"), capture=True)
    got = {"exact": ctl["exact"], "analog": ctl["analog"],
           "scores": ctl["scores"], "judged": ctl["scores"],
           "sites": ctl["sites"]}
    del ctl
    return gaps(run, got, reference_outputs(run, Precision("stated")))


def program_readings(run) -> dict:
    """The program's numbers without a window: set-up, every sampled point
    once through the window's call, the check's comparison."""
    setup(run)
    run.attempted = run.failed = 0
    pts = points(run.traffic)
    for k in run.sampled:
        run.capture_for = k
        rep = one_point(run, pts[k])
        run.records.append({"point": k, "ms": 0.0, "report": rep})
    run.capture_for = None
    run.restore()
    run.state.clear()
    got = program_outputs(run)
    return gaps(run, got, reference_outputs(run, Precision("stated")))
