"""The port's Mixture-of-Experts FFN and Mamba-2 block against the JAX
reference on the CPU, on the reference's parameters (``models.common.
init_params`` of the smoke configs, handed over with
``params_from_reference``) and shared numpy inputs.

Bounds (float32; the port's einsums and reductions run in another order
than XLA:CPU's fused ones, ROADMAP C3):

* ``moe_ffn``: expert indices and the kept (not dropped) choices equal;
  output max |d| <= 1e-5 x max |output| (norm-wise: outputs reach ~40 on
  unit-normal inputs and gate-weighted sums cancel; measured 2.2e-6);
  aux loss rtol 1e-6;
* ``mamba_forward``, the decode recurrence and the prefill-to-decode
  state handoff: atol 2e-5 on outputs and states of order 1-10 (measured
  up to 2.8e-6); the conv state is a slice of one product: equal;
* port-only duality checks at the reference's own bounds
  (``tests/test_models.py``): chunked == stepwise within 1e-3, one expert
  top-1 == the dense FFN within 1e-4;
* ``moe_ffn`` against the one-hot einsum formulation it replaced
  (``tests/_moe_oracle.py``), on the same parameters: the dispatched rows
  equal; float32 output max |d| <= 1e-6 x max |output| (the return sums
  each token's slots in another order than the GEMM); every gradient
  leaf max |d| <= 1e-5 x its max |value| (top-1's router in float64:
  in float32 it is rounding noise), and bit-equal from one backward to
  the next; bfloat16 output within one bfloat16 step of the oracle's
  (both sum in float32 and round once); the index Functions' backward
  the derivative of their forward (``gradcheck``);
* ``moe_ffn`` counts no FLOP but the router's and the three expert
  products'.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _moe_oracle import one_hot_moe

from repro.configs.registry import smoke_config as j_smoke
from repro.models import ffn as JF
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.common import init_params as j_init
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.common import init_params as t_init

MOE_TOL = 1e-5
AUX_RTOL = 1e-6
ORACLE_OUT = 1e-6
ORACLE_GRAD = 1e-5
BF16_STEP = 2.0 ** -7     # one bfloat16 step over the value, at most
SSM_ATOL = 2e-5
MOE_ARCHS = ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
             "jamba-1.5-large-398b"]
SSM_ARCHS = ["mamba2-780m", "jamba-1.5-large-398b"]


def _params(specs_fn, arch, seed=0):
    jcfg = j_smoke(arch)
    jp = j_init(specs_fn(jcfg), jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    return jcfg, jp, smoke_config(arch), tp


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ref_routing(jp, x, jcfg):
    """The reference's expert indices and kept choices (its ``moe_ffn``
    lines 77-92, which it does not return)."""
    B, S, d = x.shape
    e, k = jcfg.moe.num_experts, jcfg.moe.top_k
    tg = min(JF.MOE_GROUP, B * S)
    cap = tg * k if tg <= 64 else max(4, int(tg * k * JF.CAPACITY_FACTOR
                                             / e))
    logits = jnp.asarray(x).reshape(-1, tg, d) @ jp["router"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    sel = jax.nn.one_hot(idx, e).reshape(-1, tg * k, e)
    pos = jnp.sum((jnp.cumsum(sel, axis=1) - sel) * sel, axis=-1)
    return np.asarray(idx), np.asarray(pos.reshape(idx.shape) < cap)


def _hold_moe(arch, x, jcfg, jp, cfg, tp):
    yj, aj = JF.moe_ffn(jp, jnp.asarray(x), jcfg)
    yt, at = TF.moe_ffn(tp, torch.from_numpy(x), cfg)
    _, _, idx, _, _, keep = TF.moe_route(tp, torch.from_numpy(x), cfg)
    ridx, rkeep = _ref_routing(jp, x, jcfg)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    yj = np.asarray(yj)
    d = np.abs(yt.numpy() - yj).max()
    assert d <= MOE_TOL * np.abs(yj).max(), (arch, d, np.abs(yj).max())
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_RTOL)
    return keep


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch):
    """Dropless (32 tokens per group): output, aux, expert indices; llama4
    adds the shared expert, jamba 16 experts' smoke reduction (4, top-2)."""
    jcfg, jp, cfg, tp = _params(JF.moe_specs, arch)
    if arch.startswith("llama4"):
        assert "shared" in tp and cfg.moe.shared_expert
    x = _x((2, 16, cfg.d_model))
    keep = _hold_moe(arch, x, jcfg, jp, cfg, tp)
    assert bool(keep.all())


def test_moe_capacity_drop_matches_reference():
    """B x S = 128 > 64: capacity max(4, int(128 k 1.25 / e)) = 80 slots per
    expert for olmoe's smoke (4 experts, top-2); inputs shifted along
    router column 0 send most tokens to expert 0, overfilling it, and the
    port drops the same choices."""
    jcfg, jp, cfg, tp = _params(JF.moe_specs, "olmoe-1b-7b")
    assert TF.moe_capacity(128, 2, 4) == 80
    r0 = np.asarray(jp["router"])[:, 0]
    x = _x((2, 64, cfg.d_model)) + (4.0 * r0 / np.linalg.norm(r0)).astype(
        np.float32)
    keep = _hold_moe("olmoe capacity", x, jcfg, jp, cfg, tp)
    dropped = int((~keep).sum())
    assert 0 < dropped < keep.numel(), dropped


def test_moe_capacity_rule():
    assert TF.moe_capacity(64, 8, 64) == 512         # dropless up to 64
    assert TF.moe_capacity(128, 8, 64) == 20         # olmoe at 2 x 64
    assert TF.moe_capacity(65, 1, 128) == 4          # at least 4 slots


def test_moe_single_expert_equals_dense():
    """The reference's ``test_moe_single_expert_equals_dense`` on the port."""
    cfg = dataclasses.replace(
        smoke_config("olmoe-1b-7b"),
        moe=MoEConfig(num_experts=1, top_k=1, d_expert=64))
    p = t_init(TF.moe_specs(cfg), cfg, torch.Generator().manual_seed(0),
               "cpu")
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    y_moe, _ = TF.moe_ffn(p, x, cfg)
    dense = {k: p[k][0] for k in ("w_gate", "w_up", "w_down")}
    np.testing.assert_allclose(y_moe.numpy(),
                               TF.dense_ffn(dense, x, cfg).numpy(),
                               atol=1e-4, rtol=1e-4)


def _shifted(jp, col, scale, shape, d):
    """Unit-normal inputs shifted by ``scale`` along router column ``col``."""
    r = np.asarray(jp["router"])[:, col]
    return _x(shape + (d,)) + (scale * r / np.linalg.norm(r)).astype(
        np.float32)


def _oracle_case(case):
    """(cfg, port params, x) of one case; each asserts what it exercises."""
    arch = {"llama4_top1_shared": "llama4-maverick-400b-a17b",
            "jamba": "jamba-1.5-large-398b"}.get(case, "olmoe-1b-7b")
    jcfg, jp, cfg, tp = _params(JF.moe_specs, arch)
    d = cfg.d_model
    x = {"capacity_drop": lambda: _shifted(jp, 0, 4.0, (2, 64), d),
         "idle_expert": lambda: _shifted(jp, 3, -4.0, (2, 16), d)}.get(
        case, lambda: _x((2, 16, d)))()
    _, _, idx, _, _, keep = TF.moe_route(tp, torch.from_numpy(x), cfg)
    if case == "capacity_drop":
        assert 0 < int((~keep).sum()) < keep.numel()
    else:
        assert bool(keep.all())
    if case == "idle_expert":
        assert not bool((idx == 3).any())
    if case == "llama4_top1_shared":
        assert cfg.moe.top_k == 1 and cfg.moe.shared_expert
    return cfg, tp, x


ORACLE_CASES = ["dropless", "capacity_drop", "idle_expert",
                "llama4_top1_shared", "jamba"]


def _leaves(p, prefix=""):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _grads(fn, p, x, cfg):
    """(output, {leaf: gradient}) of sum(y * fixed weights) + aux."""
    p = {k: ({a: b.clone().requires_grad_() for a, b in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_())
         for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, aux = fn(p, x, cfg)[:2]
    w = torch.from_numpy(_x(tuple(y.shape), seed=7)).to(
        torch.promote_types(y.dtype, torch.float32))
    names, leaves = zip(*_leaves(p))
    grads = torch.autograd.grad((y.to(w.dtype) * w).sum() + aux,
                                (x,) + leaves)
    return y.detach(), dict(zip(("x",) + names, grads))


def _hold_grads(g, g_o, names):
    for name in names:
        d = float((g[name] - g_o[name]).abs().max())
        assert d <= ORACLE_GRAD * float(g_o[name].abs().max()), (name, d)


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_moe_ffn_matches_one_hot_oracle(case):
    """Float32: the dispatch is the same copy, the return the same sum in
    another order; the gradients of x, the router and every expert weight
    agree and repeat bit for bit.  Top-1's router gradient is held in
    float64 (``test_moe_top1_router_gradient_matches_one_hot_oracle``)."""
    cfg, tp, x = _oracle_case(case)
    x = torch.from_numpy(x)
    _, _, _, _, routes, _ = TF.moe_route(tp, x, cfg)
    slots = routes.token_slot    # each token's in ascending expert order
    assert bool((slots[:, 1:] >= slots[:, :-1]).all())
    xe = TF.MoEDispatch.apply(x.reshape(-1, cfg.d_model), routes)
    xe_o = one_hot_moe(tp, x, cfg)[2]
    assert torch.equal(xe, xe_o.reshape(xe.shape))
    y, g = _grads(TF.moe_ffn, tp, x, cfg)
    y_o, g_o = _grads(one_hot_moe, tp, x, cfg)
    d = float((y - y_o).abs().max())
    assert d <= ORACLE_OUT * float(y_o.abs().max()), (case, d)
    assert sorted(g) == sorted(g_o)
    _hold_grads(g, g_o, [n for n in g
                         if n != "router" or cfg.moe.top_k > 1])
    _, again = _grads(TF.moe_ffn, tp, x, cfg)
    assert all(torch.equal(g[n], again[n]) for n in g)


def test_moe_top1_router_gradient_matches_one_hot_oracle(monkeypatch):
    """With top 1, the renormalized gate is v / v: its derivative is 0, so
    in float32 the router's gradient through it is rounding noise of the
    gate's gradient (each side's its own; 7.7e-2 of the leaf's max apart),
    beside the aux loss's.  In float64 (both sides widened, as
    ``test_torch_train.py`` widens the port) that noise is gone and every
    leaf, the router's too, agrees within ORACLE_GRAD."""
    import _moe_oracle
    cfg, tp, x = _oracle_case("llama4_top1_shared")
    monkeypatch.setattr(TF, "_F32", torch.float64)
    monkeypatch.setattr(_moe_oracle, "F32", torch.float64)
    tp = {k: ({a: b.double() for a, b in v.items()}
              if isinstance(v, dict) else v.double()) for k, v in tp.items()}
    x = torch.from_numpy(x).double()
    _, g = _grads(TF.moe_ffn, tp, x, cfg)
    _, g_o = _grads(one_hot_moe, tp, x, cfg)
    assert g["router"].dtype == torch.float64
    _hold_grads(g, g_o, g)


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_moe_ffn_bf16_matches_one_hot_oracle(case):
    """Bfloat16 inputs: the oracle's return is a bfloat16 GEMM (float32
    sums, one rounding), the port's a float32 sum of the gates rounded to
    bfloat16 times the slot rows, rounded once: within one bfloat16 step
    of the oracle's value."""
    cfg, tp, x = _oracle_case(case)
    x = torch.from_numpy(x).to(torch.bfloat16)
    _, _, _, _, routes, _ = TF.moe_route(tp, x, cfg)
    xe = TF.MoEDispatch.apply(x.reshape(-1, cfg.d_model), routes)
    y_o, _, xe_o = one_hot_moe(tp, x, cfg)
    assert torch.equal(xe, xe_o.reshape(xe.shape))
    y, _ = TF.moe_ffn(tp, x, cfg)
    assert y.dtype == y_o.dtype == torch.bfloat16
    y, y_o = y.float(), y_o.float()
    step = BF16_STEP * y_o.abs() + ORACLE_OUT * float(y_o.abs().max())
    assert bool(((y - y_o).abs() <= step).all()), case


def test_moe_dispatch_and_combine_backward_is_their_derivative(monkeypatch):
    """``gradcheck`` (float64) of the two index Functions on the capacity
    case's tables, which hold empty slots and dropped choices: each
    backward is the derivative of its forward, sentinels included (the
    gates of dropped choices are drawn non-zero: the return ignores
    them)."""
    cfg, tp, x = _oracle_case("capacity_drop")
    routes = TF.moe_route(tp, torch.from_numpy(x), cfg)[4]
    n, k = routes.token_slot.shape
    slots = routes.slot_token.numel()
    assert bool((routes.token_slot == slots).any())
    assert bool((routes.slot_token == n).any())
    monkeypatch.setattr(TF, "_F32", torch.float64)
    g = torch.Generator().manual_seed(0)

    def draw(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64,
                          requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: TF.MoEDispatch.apply(a, routes), (draw(n, 4),))
    assert torch.autograd.gradcheck(
        lambda a, b: TF.MoECombine.apply(a, b, routes),
        (draw(slots, 4), draw(n, k)))


@pytest.mark.parametrize("case", ["dropless", "capacity_drop", "jamba"])
def test_moe_ffn_counts_only_router_and_expert_products(case):
    """2 G Tg d E (the router) + 3 x 2 E G C d f (the expert products): no
    FLOP over the one-hot (token, slot) axes is left."""
    cfg, tp, x = _oracle_case(case)
    B, S, d = x.shape
    e, k, f = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert
    tg = min(TF.MOE_GROUP, B * S)
    G, cap = B * S // tg, TF.moe_capacity(tg, k, e)
    with FlopCounterMode(display=False) as counter:
        TF.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert counter.get_total_flops() == (2 * G * tg * d * e
                                         + 3 * 2 * e * G * cap * d * f)


def test_top_k_ties_to_lower_index():
    """``jax.lax.top_k`` returns the lower index first on ties."""
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    v, i = TF.top_k(torch.from_numpy(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("L", [16, 13])
def test_mamba_forward_matches_reference(arch, L):
    """At a chunk multiple (16 = 2 chunks of 8) and padded (13)."""
    jcfg, jp, cfg, tp = _params(JS.mamba_specs, arch)
    x = _x((2, L, cfg.d_model))
    yj = np.asarray(JS.mamba_forward(jp, jnp.asarray(x), jcfg))
    yt = TS.mamba_forward(tp, torch.from_numpy(x), cfg)
    assert yt.shape == (2, L, cfg.d_model)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=SSM_ATOL)


@pytest.mark.parametrize("L", [16, 13, 5])
def test_mamba_state_after_matches_reference(L):
    jcfg, jp, cfg, tp = _params(JS.mamba_specs, "mamba2-780m")
    x = _x((2, L, cfg.d_model))
    sj = JM._mamba_state_after(jp, jnp.asarray(x), jcfg)
    st = TS.mamba_state_after(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(sj["conv"]))
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(sj["ssm"]),
                               rtol=0, atol=SSM_ATOL)


def test_mamba_decode_steps_match_reference():
    """The recurrence over 12 tokens from a prefilled state, both sides."""
    jcfg, jp, cfg, tp = _params(JS.mamba_specs, "mamba2-780m")
    x = _x((2, 20, cfg.d_model))
    jc = JM._mamba_state_after(jp, jnp.asarray(x[:, :8]), jcfg)
    tc = TS.mamba_state_after(tp, torch.from_numpy(x[:, :8]), cfg)
    for t in range(8, 20):
        yj, jc = JS.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                      jcfg)
        yt, tc = TS.mamba_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tc, cfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=SSM_ATOL, err_msg=f"token {t}")
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0,
                                   atol=SSM_ATOL, err_msg=k)


def test_mamba_chunked_equals_stepwise():
    """The reference's ``test_mamba_chunked_equals_stepwise`` on the port,
    and the chunked forward's final state equal to the stepwise one."""
    cfg = smoke_config("mamba2-780m")
    p = t_init(TS.mamba_specs(cfg), cfg, torch.Generator().manual_seed(0),
               "cpu")
    B, L = 2, 16
    x = torch.from_numpy(_x((B, L, cfg.d_model), scale=0.1))
    y_chunked = TS.mamba_forward(p, x, cfg)
    cache = TS.init_mamba_cache(cfg, B, torch.float32)
    ys = []
    for t in range(L):
        y_t, cache = TS.mamba_decode_step(p, x[:, t:t + 1], cache, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-3, rtol=1e-3)
    st = TS.mamba_state_after(p, x, cfg)
    np.testing.assert_allclose(st["ssm"].numpy(), cache["ssm"].numpy(),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(st["conv"].numpy(), cache["conv"].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_softplus_is_logaddexp():
    x = torch.tensor([-50.0, -3.0, 0.0, 3.0, 19.0, 21.0, 100.0])
    np.testing.assert_array_equal(
        TS.softplus(x).numpy(), np.asarray(jax.nn.softplus(
            jnp.asarray(x.numpy()))))
