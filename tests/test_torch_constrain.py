"""The activation-sharding hook's sites (``models.sharding_hooks.constrain``)
against the reference's, on the CPU: a recording policy installed on both
sides, the ``(kind, shape)`` multiset of ``forward_train``,
``serve_prefill`` and ``serve_step`` for every arch's smoke config.

The reference traces each ``lax.scan`` body once, so its sites inside a
scan body count once per iteration: ``jax.lax.scan`` is wrapped for the
test to multiply them by the scan's length.  With no policy installed
``constrain`` returns its argument itself.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.models import model as JM
from repro.models import sharding_hooks as JH
from repro_torch.configs.registry import smoke_config
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks as TH

B, S, MAX_SEQ = 2, 16, 24


def _batch(cfg):
    rng = np.random.default_rng(0)
    text = S if cfg.n_encoder_layers else S - cfg.frontend_positions
    b = {"tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)}
    b["labels"] = rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)
    if cfg.frontend_positions:
        key = "encoder_frames" if cfg.n_encoder_layers else "frontend_embeds"
        b[key] = rng.standard_normal(
            (B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return b


@pytest.fixture
def ref_sites(monkeypatch):
    """Record the reference's sites, scan bodies once per iteration."""
    sites = collections.Counter()
    lengths = []
    scan = jax.lax.scan

    def counted_scan(f, init, xs=None, length=None, **kw):
        n = length if xs is None else jax.tree_util.tree_leaves(xs)[0].shape[0]
        lengths.append(n)
        try:
            return scan(f, init, xs, length=length, **kw)
        finally:
            lengths.pop()

    def policy(x, kind):
        sites[(kind, tuple(x.shape))] += int(np.prod(lengths))
        return x

    monkeypatch.setattr(jax.lax, "scan", counted_scan)
    JH.set_policy(policy)
    yield sites
    JH.set_policy(None)


@pytest.fixture
def port_sites():
    sites = collections.Counter()

    def policy(x, kind):
        sites[(kind, tuple(x.shape))] += 1
        return x

    TH.set_policy(policy)
    yield sites
    TH.set_policy(None)


@pytest.mark.parametrize("path", ["forward_train", "serve_prefill",
                                  "serve_step"])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_constrain_sites_match_reference(arch, path, ref_sites, port_sites):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    b = _batch(cfg)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    serve_b = {k: v for k, v in jb.items() if k != "labels"}
    serve_tb = {k: v for k, v in tb.items() if k != "labels"}
    tok = np.zeros((B, 1), np.int32)
    with torch.no_grad():
        if path == "forward_train":
            JM.forward_train(jp, jcfg, jb)
            TM.forward_train(tp, cfg, tb)
        elif path == "serve_prefill":
            JM.serve_prefill(jp, jcfg, serve_b, MAX_SEQ)
            TM.serve_prefill(tp, cfg, serve_tb, MAX_SEQ)
        else:
            _, jc = JM.serve_prefill(jp, jcfg, serve_b, MAX_SEQ)
            _, tc = TM.serve_prefill(tp, cfg, serve_tb, MAX_SEQ)
            ref_sites.clear()
            port_sites.clear()
            JM.serve_step(jp, jcfg, jc, jnp.asarray(tok))
            TM.serve_step(tp, cfg, tc, torch.from_numpy(tok))
    assert port_sites and port_sites == ref_sites


def test_no_policy_is_the_identity():
    x = torch.ones(2, 3)
    assert TH.constrain(x, "act_btd") is x
    assert TH.gather({"w": x}, "blocks")["w"] is x
