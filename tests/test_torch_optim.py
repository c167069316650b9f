"""The port's optimizer against the JAX reference on the CPU: ``adamw_update``
and ``global_norm`` on shared trees (float32 and bfloat16 moments,
clipping on and off, several steps), ``wsd_schedule`` at the steps that
matter, and the reference's own optimizer cases run on the port.

Bounds: ``wsd_schedule`` equal (both are float32 arithmetic on the same
operations); the gradient norm within rtol 1e-6 (the leaves' sums
reduce in another order, so the two may sit one float32 ulp apart); the
updated parameters and float32 moments within 1e-6 x the leaf's largest
|value| (measured <= 2.1e-7: XLA fuses multiply-adds where the port rounds
twice, and a one-ulp norm moves the clip scale; an element-wise rtol
would not hold where b1 m and (1 - b1) g nearly cancel, measured 5.6e-6
there) and bfloat16 moments at most one bfloat16 ulp apart (a float32
difference of one ulp can round to either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import wsd_schedule as j_wsd
from repro.optim.adamw import global_norm as j_norm
from repro_torch._tree import tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, wsd_schedule)

RTOL = 1e-6


def _tree(seed, scale=1.0, dtype=np.float32):
    """A parameter-like tree whose dict insertion order is not sorted."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((7, 5)) * scale).astype(dtype),
            "b": {"z": (rng.standard_normal((3,)) * scale).astype(dtype),
                  "a": (rng.standard_normal((2, 4, 3)) * scale).astype(dtype)},
            "emb": (rng.standard_normal((11, 2)) * scale).astype(dtype)}


def _t(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(tree, np.float32))
    return t.to(dtype) if dtype is not None else t


def _j(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("step", [0, 1, 10, 99, 100, 7999, 9000, 9999])
@pytest.mark.parametrize("base", [1.0, 3e-4, 1e-2])
def test_wsd_schedule_equals_reference(step, base):
    want = np.float32(j_wsd(step, base))
    got = wsd_schedule(step, base)
    assert got.dtype == torch.float32
    assert got.item() == want
    assert wsd_schedule(torch.tensor(step), base).item() == want


def test_global_norm_sums_in_sorted_key_order():
    tree = _tree(0, scale=3.0)
    want = float(j_norm(_j(tree)))
    got = global_norm(_t(tree))
    assert got.dtype == torch.float32
    assert got.item() == pytest.approx(want, rel=RTOL)
    reordered = {"emb": tree["emb"], "b": {"a": tree["b"]["a"],
                                           "z": tree["b"]["z"]},
                 "w": tree["w"]}
    assert global_norm(_t(reordered)).item() == got.item()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adamw_update_equals_reference(state_dtype, grad_scale):
    cfg_j, cfg_t = JAdamW(lr=1e-2), AdamWConfig(lr=1e-2)
    p_np = _tree(1)
    jp, tp = _j(p_np), _t(p_np)
    jm, jv = j_init(jp, state_dtype)
    tm, tv = adamw_init(tp, state_dtype)
    assert all(x.dtype == getattr(torch, state_dtype)
               for x in tree_leaves(tm) + tree_leaves(tv))
    for step in (0, 1, 2, 500):
        g_np = _tree(10 + step, scale=grad_scale)
        lr = 3e-3 * (step + 1)
        jp, jm, jv, jgn = j_update(jp, _j(g_np), jm, jv, jnp.asarray(step),
                                   cfg_j, jnp.float32(lr))
        tp, tm, tv, tgn = adamw_update(tp, _t(g_np), tm, tv, step, cfg_t,
                                       lr)
        assert tgn.item() == pytest.approx(float(jgn), rel=RTOL)
        for jt, tt in ((jp, tp), (jm, tm), (jv, tv)):
            for a, b in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
                a32 = np.asarray(jnp.asarray(a, jnp.float32))
                b32 = b.float().numpy()
                if b.dtype == torch.bfloat16:
                    ulp = np.abs(a32) * 2.0 ** -7 + 1e-30
                    assert (np.abs(a32 - b32) <= ulp).all()
                else:
                    assert np.abs(a32 - b32).max() <= \
                        RTOL * np.abs(a32).max(), (step, a.shape)


def test_adamw_update_is_functional_and_keeps_requires_grad():
    p = {"w": torch.ones(3, requires_grad=True),
         "n": torch.zeros(2, dtype=torch.bfloat16)}
    m, v = adamw_init(p)
    g = {"w": torch.ones(3), "n": torch.ones(2, dtype=torch.bfloat16)}
    p2, m2, v2, _ = adamw_update(p, g, m, v, 5, AdamWConfig())
    assert p2["w"].requires_grad and p2["w"].is_leaf
    assert not p2["n"].requires_grad and p2["n"].dtype == torch.bfloat16
    assert torch.equal(p["w"].detach(), torch.ones(3))
    assert torch.equal(m["w"], torch.zeros(3))
    assert not torch.equal(p2["w"].detach(), p["w"].detach())


# --- the reference's optimizer cases (tests/test_substrate.py) on the port ---

def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    m, v = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    best = float("inf")
    for step in range(120):
        w = params["w"].clone().requires_grad_()
        g, = torch.autograd.grad(torch.sum(torch.square(w)), [w])
        params, m, v, gn = adamw_update(params, {"w": g}, m, v, step, cfg)
        best = min(best, float(torch.sum(torch.square(params["w"]))))
    assert best < 1e-2


def test_adamw_clip():
    params = {"w": torch.zeros(3)}
    m, v = adamw_init(params)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, _, gn = adamw_update(params, g, m, v, 0, AdamWConfig(clip_norm=1.0))
    assert float(gn) == pytest.approx(100.0)


def test_adamw_bf16_state():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    m, v = adamw_init(params, "bfloat16")
    assert m["w"].dtype == torch.bfloat16
    g = {"w": torch.ones(4, dtype=torch.bfloat16)}
    p2, m2, v2, _ = adamw_update(params, g, m, v, 0, AdamWConfig())
    assert p2["w"].dtype == torch.bfloat16 and m2["w"].dtype == torch.bfloat16


def test_wsd_schedule():
    assert float(wsd_schedule(0, 1.0, warmup=10, total=100)) == 0.0
    assert float(wsd_schedule(10, 1.0, warmup=10, total=100)) == \
        pytest.approx(1.0)
    assert float(wsd_schedule(99, 1.0, warmup=10, total=100)) < 0.25
