"""The sharded training step (``launch.sharded_step``) on gloo ranks of this
CPU, against the one-rank step and the reference's unsharded jit.

Each mesh runs once, as child processes (``python -c``, a ``file://``
rendezvous under the test's temporary directory, so parallel test workers
never share a port): (1, 1), (2, 1), (1, 2), (2, 2) and (1, 4).  On each,
qwen2-0.5b's smoke config (tensor-parallel rules), qwen3-8b's (an
``FSDP_ARCHS`` prefix match: the embed axis over ``data``) and, on the
meshes without a second data rank, olmoe-1b-7b's (experts over
``model``; a data split changes an MoE step, ``sharded_step``'s note)
take 3 steps of B 4 x S 32 in 2 microbatches (lr 0, 1e-4, 2e-4 of the
warmup, as ``tests/test_torch_train_steps.py``).  Every rank checks its
parameter and moment bytes against ``ShardPlan.state_bytes``; rank 0
gathers the final state.  The (2, 2) mesh also runs the DTensor round
trip of ``resolve_pspec`` specs, and 3 steps from the reference's
parameters held against the reference's ``jax.jit`` of its
``make_train_step`` at C16's bounds.

Bounds against the one-rank step (measured on this CPU, in brackets;
meshes without a second data rank came out bit-equal but for qwen3-8b's
and olmoe's embedding-sized leaves):
* (1, 1): equal bit for bit — losses, gradient norms, parameters,
  moments;
* loss rtol 1e-6 [<= 7.1e-8], gradient norm rtol 1e-6 [<= 1.9e-7];
* parameters: max |d| <= 1e-5 [<= 1.07e-6] (C16's: a twentieth of a
  step's largest move) and at most 1% of the elements more than 1e-6
  relative apart [<= 0.33%: the zero-initialized norm scales' small
  moves follow their gradients' rounding];
* moments m and v: max |d| <= 1e-4 of the leaf's largest |value|
  [<= 1.9e-5]: the data ranks' gradients are summed in another order.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch._tree import dict_leaves, map_dict, tree_map
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data import batch_at
from repro_torch.launch import steps as ST
from repro_torch.launch.train import data_config
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init

REPO = Path(__file__).resolve().parents[1]
B, S, MICRO, STEPS, LR, TOTAL = 4, 32, 2, 3, 1e-2, 10
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
MOE_MESHES = [(1, 1), (1, 2), (1, 4)]
LOSS_RTOL = 1e-6
NORM_RTOL = 1e-6
PARAM_ATOL = 1e-5
PARAM_SHARE = 0.01
MOMENT_RTOL = 1e-4
CHILD_TIMEOUT_S = 120


def _jobs(mesh):
    jobs = [{"arch": "qwen2-0.5b"}, {"arch": "qwen3-8b"}]
    if tuple(mesh) in MOE_MESHES:
        jobs.append({"arch": "olmoe-1b-7b"})
    if tuple(mesh) == (2, 2):
        jobs.append({"arch": "qwen2-0.5b", "params": "ref_params.pt",
                     "tag": "ref"})
    return jobs


def _shape():
    return ShapeConfig("t", "train", S, B, microbatches=MICRO)


def _batches(cfg):
    dc = data_config(cfg, _shape())
    return [batch_at(dc, s) for s in range(STEPS)]


def _state(params, m, v):
    return {"params": params, "m": m, "v": v}


def run_rank(rank, world, mesh_shape, root, jobs):
    """One rank of a child process group: each job's 3 sharded steps; rank
    0 writes the metrics and the gathered final state."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharded_step import ShardPlan

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'pg'}",
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(mesh_shape[1], device_type="cpu")
        for job in jobs:
            cfg = smoke_config(job["arch"])
            plan = ShardPlan(cfg, mesh)
            full = (torch.load(root.parent / job["params"])
                    if "params" in job else
                    TM.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"))
            params = tree_map(lambda p: p.requires_grad_(), plan.shard(full))
            m, v = adamw_init(params, cfg.opt_state_dtype)
            got = {"params": sum(t.nbytes for t in dict_leaves(params)),
                   "moments": sum(t.nbytes for t in dict_leaves(m))
                   + sum(t.nbytes for t in dict_leaves(v))}
            assert got == plan.state_bytes(), (got, plan.state_bytes())
            step = ST.make_train_step(cfg, _shape(), AdamWConfig(lr=LR),
                                      total_steps=TOTAL, plan=plan)
            metrics = []
            for s, b in enumerate(_batches(cfg)):
                b = {k: torch.from_numpy(np.ascontiguousarray(x))
                     for k, x in plan.shard_batch(_shape(), b).items()}
                params, m, v, _, met = step(params, m, v, s, b)
                metrics.append([float(met[k]) for k in
                                ("loss", "grad_norm", "lr")])
            with torch.no_grad():
                full_state = {k: map_dict(lambda x, sp: plan._gather(
                    x.detach(), sp).clone(), t, plan.specs)
                    for k, t in _state(params, m, v).items()}
            if rank == 0:
                torch.save({"metrics": metrics, "state": full_state,
                            "bytes": got},
                           root / f"{job.get('tag', job['arch'])}.pt")
        if mesh_shape == [2, 2]:
            dtensor_round_trip(mesh, root, rank)
    finally:
        dist.destroy_process_group()


def dtensor_round_trip(mesh, root, rank):
    """``resolve_pspec`` specs as DTensor placements: each rank's local
    shard is ``shard_region``'s slice and the full tensor round-trips."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import sharding as SH

    rules = {"embed": ("data",), "ffn": ("model",), "both": ("data",
                                                             "model")}
    cases = [((8, 6), ("embed", "ffn")), ((7, 6), ("embed", "ffn")),
             ((8,), ("both",)), ((6,), ("both",)), ((8, 8), ("embed",
                                                              "embed"))]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for shape, axes in cases:
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
            shape)
        spec = SH.resolve_pspec(shape, axes, rules, mesh)
        dt = distribute_tensor(x, mesh, SH.placements(spec, mesh))
        assert torch.equal(dt.to_local(),
                           x[SH.shard_region(shape, spec, mesh, coord)])
        assert torch.equal(dt.full_tensor(), x)
    if rank == 0:
        (root / "dtensor.ok").touch()


CHILD = """
import json, sys
sys.path[:0] = json.loads(sys.argv[1])
from test_torch_sharded_step import run_rank
run_rank(int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4]),
         sys.argv[5], json.loads(sys.argv[6]))
"""


def run_mesh(mesh, root: Path, jobs):
    """Run ``jobs`` on a (data, model) mesh of child ranks under ``root``."""
    root.mkdir(parents=True)
    world = mesh[0] * mesh[1]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    paths = json.dumps([str(REPO / "src"), str(REPO / "tests")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD), paths, str(r),
         str(world), json.dumps(list(mesh)), str(root), json.dumps(jobs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=CHILD_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's results, the one-rank steps', and the reference's."""
    root = tmp_path_factory.mktemp("sharded")
    ref = _reference_run(root)
    out = {"ref": ref}
    for mesh in MESHES:
        d = root / f"{mesh[0]}x{mesh[1]}"
        run_mesh(mesh, d, _jobs(mesh))
        out[mesh] = {p.stem: torch.load(p) for p in d.glob("*.pt")}
        out[mesh]["dtensor"] = (d / "dtensor.ok").exists()
    out["one_rank"] = {a: _one_rank(a) for a in ("qwen2-0.5b", "qwen3-8b",
                                                  "olmoe-1b-7b")}
    return out


def _one_rank(arch, full=None):
    cfg = smoke_config(arch)
    params = full if full is not None else TM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    m, v = adamw_init(params, cfg.opt_state_dtype)
    step = ST.make_train_step(cfg, _shape(), AdamWConfig(lr=LR),
                              total_steps=TOTAL)
    metrics = []
    for s, b in enumerate(_batches(cfg)):
        params, m, v, _, met = step(params, m, v, s, {
            k: torch.from_numpy(np.ascontiguousarray(x))
            for k, x in b.items()})
        metrics.append([float(met[k]) for k in ("loss", "grad_norm", "lr")])
    return {"metrics": metrics, "state": _state(
        tree_map(lambda x: x.detach(), params), m, v)}


def _reference_run(root):
    """The reference's parameters (saved for the (2, 2) children) and its
    jitted unsharded step over the same 3 batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.registry import smoke_config as j_smoke
    from repro.launch import steps as JST
    from repro.models import model as JM
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as j_init

    jcfg = j_smoke("qwen2-0.5b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    torch.save(TM.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        root / "ref_params.pt")
    jm, jv = j_init(jp, jcfg.opt_state_dtype)
    jstep = jax.jit(JST.make_train_step(
        jcfg, JShape("t", "train", S, B, microbatches=MICRO),
        JAdamW(lr=LR), total_steps=TOTAL))
    j_s, metrics = jnp.zeros((), jnp.int32), []
    for b in _batches(smoke_config("qwen2-0.5b")):
        jp, jm, jv, j_s, met = jstep(jp, jm, jv, j_s,
                                     {k: jnp.asarray(x) for k, x in
                                      b.items()})
        metrics.append([float(met[k]) for k in ("loss", "grad_norm", "lr")])
    return {"metrics": metrics, "state": {
        k: jax.tree_util.tree_map(np.asarray, t)
        for k, t in (("params", jp), ("m", jm), ("v", jv))}}


def _cases():
    return [(a, m) for a in ("qwen2-0.5b", "qwen3-8b") for m in MESHES] + [
        ("olmoe-1b-7b", m) for m in MOE_MESHES]


@pytest.mark.parametrize("arch,mesh", _cases())
def test_sharded_step_matches_one_rank(arch, mesh, runs):
    got, want = runs[mesh][arch], runs["one_rank"][arch]
    if mesh == (1, 1):
        assert got["metrics"] == want["metrics"]
        for k in ("params", "m", "v"):
            for a, b in zip(dict_leaves(got["state"][k]),
                            dict_leaves(want["state"][k])):
                assert torch.equal(a, b), k
        return
    for (l, n, lr), (l1, n1, lr1) in zip(got["metrics"], want["metrics"]):
        assert l == pytest.approx(l1, rel=LOSS_RTOL)
        assert n == pytest.approx(n1, rel=NORM_RTOL)
        assert lr == lr1
    off = total = 0
    for a, b in zip(dict_leaves(got["state"]["params"]),
                    dict_leaves(want["state"]["params"])):
        d = (a.double() - b.double()).abs()
        assert d.max().item() <= PARAM_ATOL
        off += int((d > 1e-6 * b.double().abs()).sum())
        total += b.numel()
    assert off <= PARAM_SHARE * total, off / total
    for k in ("m", "v"):
        for a, b in zip(dict_leaves(got["state"][k]),
                        dict_leaves(want["state"][k])):
            gap = (a.double() - b.double()).abs().max().item()
            assert gap <= MOMENT_RTOL * b.double().abs().max().item() \
                or gap == 0.0, (k, gap)


def test_sharded_step_bytes_per_rank_shrink_with_the_model_axis(runs):
    """Rank 0's parameter bytes (each rank asserted its own against the
    plan): model sharding divides the tensor-parallel leaves."""
    b = {m: runs[m]["qwen2-0.5b"]["bytes"]["params"] for m in MESHES}
    assert b[(1, 1)] == b[(2, 1)] > b[(1, 2)] > b[(1, 4)]
    assert runs[(2, 2)]["qwen3-8b"]["bytes"]["params"] < \
        runs[(1, 2)]["qwen3-8b"]["bytes"]["params"]


def test_dtensor_round_trip_on_four_ranks(runs):
    assert runs[(2, 2)]["dtensor"]


def test_sharded_step_against_reference_jit(runs):
    """3 steps on (2, 2) from the reference's parameters against the
    reference's unsharded jit, at C16's bounds
    (``tests/test_torch_train_steps.py``)."""
    import jax

    got, ref = runs[(2, 2)]["ref"], runs["ref"]
    for (l, n, lr), (jl, jn, jlr) in zip(got["metrics"], ref["metrics"]):
        assert l == pytest.approx(jl, rel=1e-6)
        assert n == pytest.approx(jn, rel=2e-4)
        assert lr == jlr
    off = total = 0
    for a, b in zip(dict_leaves(got["state"]["params"]),
                    jax.tree_util.tree_leaves(
                        ref["state"]["params"])):
        b = np.asarray(b, np.float64)
        d = np.abs(a.double().numpy() - b)
        assert d.max() <= 1e-5
        off += (d > 1e-6 * np.abs(b)).sum()
        total += b.size
    assert off <= 0.03 * total
    for k in ("m", "v"):
        for a, b in zip(dict_leaves(got["state"][k]),
                        jax.tree_util.tree_leaves(
                            ref["state"][k])):
            b = np.asarray(b, np.float64)
            assert np.abs(a.double().numpy() - b).max() <= \
                1e-3 * np.abs(b).max()
