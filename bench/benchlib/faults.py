"""Faults planted in the program to show that the check catches them: each
is a context manager that breaks the timed path underneath a run.

Surface cells: ``unchanged`` (the analog forward hands back the exact
logits: the point does no analog work), ``half_batch`` (the scores are the
mean over half of the sequences), ``altered`` (every position's
greedy token is changed to token 0 where the analog forward produces
the logits), ``skipped_site`` (the analog forward computes one product of
a middle layer, its ``wk``, exactly instead of through the crossbar) and,
where the model has experts, ``dropped_expert`` (the analog forward leaves
expert 0 of a middle layer out).  Training
cells: ``unchanged`` (the step returns its state as it came), ``half_batch``
(each microbatch loses half its rows, the mean taken over the rest) and
``altered`` (the step's loss is reported 1% high).  A one-card cell has no
exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

SURFACE = ("unchanged", "half_batch", "altered", "skipped_site",
           "dropped_expert")
TRAIN = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def surface(fault: str, config: dict):
    from repro_torch.imc import model_analog as ma

    if fault == "unchanged":
        def fn(params, cfg, tokens, *a, **k):
            return ma.model_forward_logits(params, cfg, tokens)
        return _patched(ma, "analog_model_logits", fn)
    if fault == "half_batch":
        orig = ma.logit_metrics

        def fn(ref, ana, tokens):
            b = max(1, ref.shape[0] // 2)
            return orig(ref[:b], ana[:b], tokens[:b])
        return _patched(ma, "logit_metrics", fn)
    if fault == "altered":
        orig = ma.analog_model_logits

        def fn(*a, **k):
            out = orig(*a, **k)
            out[..., 0] = out.amax(dim=-1) + 1.0
            return out
        return _patched(ma, "analog_model_logits", fn)
    if fault == "skipped_site":
        return _skipped_site(ma, config)
    if fault == "dropped_expert":
        return _dropped_expert()
    raise ValueError(fault)


def _middle(n_layers: int) -> int:
    return n_layers // 2


def _skipped_site(ma, config: dict):
    """The ``wk`` of the middle layer computed as ``x @ w``: the analog
    products of a forward come in the order wq, wk, wv, wo (and the dense
    FFN's three) per layer, then the unembed."""
    body = ma._fake_mvm_body
    layers = config["num_hidden_layers"]
    per = 4 if config.get("num_experts") else 7
    calls = [0]

    def fn(x, w, *a, **k):
        i = calls[0] % (layers * per + 1)
        calls[0] += 1
        if i == _middle(layers) * per + 1:
            return x.float() @ w.float()
        return body(x, w, *a, **k)
    return _patched(ma, "_fake_mvm_body", fn)


def _dropped_expert():
    """Expert 0 of the middle layer left out of the analog forward (a
    forward runs under a linear hook), its output weights zeroed."""
    from repro_torch.models import common
    from repro_torch.models import ffn as ffn_mod

    moe = ffn_mod.moe_ffn
    calls = [0]

    def fn(p, x, cfg):
        if common._LINEAR_HOOK is None:
            return moe(p, x, cfg)
        i = calls[0] % cfg.n_layers
        calls[0] += 1
        if i == _middle(cfg.n_layers):
            w_down = p["w_down"].clone()
            w_down[0] = 0.0
            p = dict(p, w_down=w_down)
        return moe(p, x, cfg)
    return _patched(ffn_mod, "moe_ffn", fn)


def train(fault: str, config: dict):
    from repro_torch.launch import steps

    orig = steps.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def broken(params, m, v, i, batch):
            if fault == "unchanged":
                _, _, _, _, metrics = step(params, m, v, i, batch)
                return params, m, v, i + 1, metrics
            if fault == "half_batch":
                rows = max(1, batch["tokens"].shape[1] // 2)
                batch = {k: t[:, :rows] for k, t in batch.items()}
                return step(params, m, v, i, batch)
            if fault == "altered":
                out = step(params, m, v, i, batch)
                out[4]["loss"] = out[4]["loss"] * 1.01
                return out
            raise ValueError(fault)
        return broken
    return _patched(steps, "make_train_step", make)


def plant(kind: str, fault: str, config: dict):
    """Fault ``fault`` of the traffic kind ``kind`` planted in the program
    that runs the benchmark's configuration ``config``."""
    return {"surface": surface, "train": train}[kind](fault, config)
