"""``launch.flops_audit`` against the reference's ``audit_step_flops`` on
all ten smoke configs: the train step (B 4 x S 64 in 2 microbatches, the
backward and its recompute included) and the prefill step (B 2 x S 64).

The port counts a step by running it on meta tensors under
``FlopCounterMode``; the reference walks the step's jaxpr.  The counts
are equal on every dense arch.  The three MoE archs and mamba2 hold a
measured gap, exact to the FLOP (ROADMAP C20):

* mamba2-780m, jamba-1.5-large-398b: the SSD's einsums without a
  contracted index (per-chunk outer products of 32,768 FLOPs at this
  size) are broadcast multiplies in torch, which the counter does not
  count, where the reference's jaxpr has ``dot_general``s, and so are
  their transposes in the backward: 6 (mamba2) and 21 (jamba) of them
  per prefill, 32 and 112 per train step;
* olmoe-1b-7b, jamba-1.5-large-398b, llama4-maverick-400b-a17b: the port
  routes experts by index (gathers and a k-way sum, no matmul), where the
  reference runs three einsums over a one-hot (Tg, E, C) tensor in each
  MoE layer: the one that builds it (163,840 FLOPs at k 2, C 80; at
  llama4's top-1 a broadcast multiply that torch never counted, 40,960),
  the dispatch and the return (5,242,880 each at C 80; 2,621,440 at
  llama4's C 40).  A prefill runs each once per MoE layer (olmoe 2,
  llama4 2, jamba 4).  A train step (2 microbatches) runs each 3 times
  per MoE layer and microbatch: the building einsum and the dispatch in
  the forward, the recompute and the backward (one transpose each), the
  return in the forward and twice in the backward (its two operands);
  the recompute re-runs the return too where later ops of its region
  save tensors for the backward (3 of jamba's 4 MoE layers).  Before,
  the port's recompute re-ran llama4's return (before its shared
  expert) where the reference's remat drops it; no return is a product
  now, so that surplus went with it.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.launch import flops_audit as JFA
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import steps as ST
from repro_torch.launch.flops_audit import audit_step_flops
from repro_torch.models import model as TM
from repro_torch.models.common import DTYPES

SHAPES = {"train": (64, 4, 2), "prefill": (64, 2, 1)}
OUTER = 32_768          # one SSD outer-product einsum at the smoke size
TOP1 = 40_960           # llama4's top-1 one-hot building einsum (k 1)
BUILD = 163_840         # the one-hot building einsum: 2 Tg E C k, k 2, C 80
ONE_HOT = 5_242_880     # the dispatch or the return einsum: 2 Tg E C d, C 80
ONE_HOT_TOP1 = 2_621_440    # the same at llama4's C 40
MOE = BUILD + 2 * ONE_HOT   # a MoE layer's one-hot einsums, k 2
MOE_TOP1 = 2 * ONE_HOT_TOP1
# port - reference, in FLOPs
GAPS = {
    ("mamba2-780m", "prefill"): -6 * OUTER,
    ("mamba2-780m", "train"): -32 * OUTER,
    ("olmoe-1b-7b", "prefill"): -2 * MOE,
    ("olmoe-1b-7b", "train"): -2 * 2 * 3 * MOE,
    ("jamba-1.5-large-398b", "prefill"): -21 * OUTER - 4 * MOE,
    ("jamba-1.5-large-398b", "train"): (-112 * OUTER - 4 * 2 * 3 * MOE
                                        - 3 * 2 * ONE_HOT),
    ("llama4-maverick-400b-a17b", "prefill"): -2 * TOP1 - 2 * MOE_TOP1,
    ("llama4-maverick-400b-a17b", "train"): -12 * TOP1 - 2 * 2 * 3 * MOE_TOP1,
}


def _moments(tree, dtype):
    if isinstance(tree, dict):
        return {k: _moments(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device="meta")


def port_flops(arch, kind):
    cfg = smoke_config(arch)
    S, B, mb = SHAPES[kind]
    shape = ShapeConfig("t", kind, S, B, microbatches=mb)
    params = TM.abstract_params(cfg)
    batch = ST.input_specs(cfg, shape)
    if kind == "prefill":
        return audit_step_flops(ST.make_prefill_step(cfg, shape), params,
                                batch)
    m = _moments(params, DTYPES[cfg.opt_state_dtype])
    return audit_step_flops(ST.make_train_step(cfg, shape), params, m, m, 0,
                            batch)


def ref_flops(arch, kind):
    cfg = j_smoke(arch)
    S, B, mb = SHAPES[kind]
    shape = JShape("t", kind, S, B, microbatches=mb)
    params = JM.abstract_params(cfg)
    batch = JST.input_specs(cfg, shape)
    if kind == "prefill":
        return JFA.audit_step_flops(JST.make_prefill_step(cfg, shape),
                                    params, batch)
    m = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape,
                                       jnp.dtype(cfg.opt_state_dtype)),
        params)
    return JFA.audit_step_flops(JST.make_train_step(cfg, shape), params, m,
                                m, jax.ShapeDtypeStruct((), jnp.int32),
                                batch)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_audit_matches_reference(arch, kind):
    got, want = port_flops(arch, kind), ref_flops(arch, kind)
    assert want > 0
    gap = GAPS.get((arch, kind), 0)
    assert got == pytest.approx(want + gap, rel=1e-9, abs=0), (got, want)


def test_audit_counts_what_runs():
    """Twice the microbatches of the same rows each: the train step's
    count doubles but for nothing (the optimizer has no matmul)."""
    cfg = smoke_config("qwen2-0.5b")
    params = TM.abstract_params(cfg)
    m = _moments(params, DTYPES[cfg.opt_state_dtype])
    counts = []
    for mb in (1, 2):
        shape = ShapeConfig("t", "train", 64, 2 * mb, microbatches=mb)
        counts.append(audit_step_flops(ST.make_train_step(cfg, shape),
                                       params, m, m, 0,
                                       ST.input_specs(cfg, shape)))
    assert counts[1] == 2 * counts[0] > 0
