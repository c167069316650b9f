"""The port's dry run (``launch.dryrun``, ``launch.live_bytes``, the dry
``ShardPlan``) against the reference's and against live steps, on the
CPU, with no full-width trace:

* ``cells`` lists the reference's cells;
* the qwen3-8b smoke cell of ``tests/test_system.py``'s mini dry run
  ((data 4, model 2), train S 64 x B 8 in 2 microbatches): argument and
  alias bytes equal XLA's ``memory_analysis()`` (211,652: the parameter
  and float32 moment shards, the rank's tokens and labels and the int32
  step), and the global FLOPs the reference's audit, from one
  subprocess with 8 host devices;
* every cell of jamba-1.5-large-398b and llama4-maverick-400b-a17b at
  full width on both production meshes: argument bytes equal the sum of
  the reference's ``NamedSharding(...).shard_shape`` per leaf (plan
  only);
* the live-bytes tracker's peak on meta equals its peak on real CPU
  tensors for the same smoke steps;
* the dry tally at (2, 2) equals rank 0's tally of a live 4-process gloo
  step, counted by a shim over ``torch.distributed``'s collectives;
* the traced FLOPs equal ``flops_audit``'s, and ``flops_audit_global``
  the unsharded step's;
* ``serve_prefill`` / ``serve_step`` give the same bits with an identity
  gather hook as with none, through each repeat's sites;
* ``main`` writes, skips and forces as the reference's.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import TRAIN_MICROBATCHES as J_TRAIN_MICROBATCHES
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as ST
from repro_torch.launch.flops_audit import audit_step_flops
from repro_torch.launch.live_bytes import LiveBytes
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks
from torch.utils.flop_counter import FlopCounterMode

REPO = Path(__file__).resolve().parents[1]
BIG = ("jamba-1.5-large-398b", "llama4-maverick-400b-a17b")
SMOKE_SHAPES = {
    "train": ShapeConfig("t", "train", 64, 4, microbatches=2),
    "prefill": ShapeConfig("p", "prefill", 64, 2),
    "decode": ShapeConfig("decode_32k", "decode", 64, 2),
}
CHILD_TIMEOUT_S = 120


def _mesh(data, model):
    return MeshShape(("data", "model"), (data, model))


def test_cells_equal_reference():
    saved = os.environ.get("XLA_FLAGS")
    try:         # the reference's module sets 512 host devices on import
        from repro.launch import dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for mp in (False, True):
        assert list(D.cells(mp)) == list(JD.cells(mp))
    assert len(list(D.cells(False))) == 32


XLA_CELL = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config
from repro.launch import sharding as SH, steps as ST
from repro.launch.flops_audit import audit_step_flops
from repro.models import model as M

cfg = smoke_config("qwen3-8b")
mesh = jax.make_mesh((4, 2), ("data", "model"))
shape = ShapeConfig("train_4k", "train", 64, 8, microbatches=2)
SH.activation_policy(mesh, cfg, shape)
ap = M.abstract_params(cfg)
ps = SH.param_shardings(cfg, mesh, M.logical_axes(cfg), ap)
batch = ST.input_specs(cfg, shape)
bs = SH.batch_shardings(mesh, shape, batch)
fn = ST.make_train_step(cfg, shape)
aopt = jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), ap)
step = jax.ShapeDtypeStruct((), jnp.int32)
jit = jax.jit(fn, in_shardings=(ps, ps, ps, None, bs),
              out_shardings=(ps, ps, ps, None, None), donate_argnums=(0, 1, 2))
m = jit.lower(ap, aopt, aopt, step, batch).compile().memory_analysis()
print(json.dumps({"argument": m.argument_size_in_bytes,
                  "alias": m.alias_size_in_bytes,
                  "flops": audit_step_flops(fn, ap, aopt, aopt, step, batch)}))
"""


def test_qwen3_cell_matches_xla():
    r = subprocess.run([sys.executable, "-c", XLA_CELL],
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    xla = json.loads(r.stdout.strip().splitlines()[-1])
    cell = D.build(smoke_config("qwen3-8b"),
                   ShapeConfig("train_4k", "train", 64, 8, microbatches=2),
                   _mesh(4, 2))
    res = D.trace(cell)
    assert xla["argument"] == 211_652
    assert res["memory"]["argument_size_in_bytes"] == xla["argument"]
    assert res["memory"]["alias_size_in_bytes"] == xla["alias"]
    # 4 data ranks split the batch: the global count is theirs
    assert res["flops_audit_global"] == xla["flops"] == 4 * res["flops_rank"]
    assert res["flops_audit_per_device"] == xla["flops"] / 8


# ------------------------------------------------ full-width plan bytes
class StubMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=np.int8)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _ref_argument_bytes(arch, shape_name, multi_pod, monkeypatch):
    """The reference's per-device argument bytes of the cell: each leaf's
    ``NamedSharding(...).shard_shape`` on an abstract production mesh."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    stub, amesh = StubMesh(sizes, names), AbstractMesh(sizes, names)
    monkeypatch.setattr(JSH, "NamedSharding",
                        lambda mesh, spec: NamedSharding(amesh, spec))
    jcfg = J_ARCHS[arch]
    shape = J_SHAPES[shape_name]
    if shape.kind == "train":
        shape = dataclasses.replace(
            shape, microbatches=J_TRAIN_MICROBATCHES[arch])

    def shard_bytes(sds, spec):
        n = math.prod(NamedSharding(amesh, spec).shard_shape(sds.shape))
        return n * np.dtype(sds.dtype).itemsize

    ap = JM.abstract_params(jcfg)
    rules = JSH.param_rules(jcfg, stub, shape.kind)
    specs = jax.tree_util.tree_map(
        lambda ax, sds: JSH.resolve_pspec(sds.shape, ax, rules, stub),
        JM.logical_axes(jcfg), ap, is_leaf=_is_axes)
    pairs = list(zip(jax.tree_util.tree_leaves(ap),
                     jax.tree_util.tree_leaves(
                         specs, is_leaf=lambda x: isinstance(
                             x, PartitionSpec))))
    total = sum(shard_bytes(s, p) for s, p in pairs)
    batch = JST.input_specs(jcfg, shape)
    bsh = JSH.batch_shardings(stub, shape, batch)
    if shape.kind == "train":
        opt = np.dtype(jcfg.opt_state_dtype).itemsize
        total += sum(2 * math.prod(NamedSharding(amesh, p).shard_shape(
            s.shape)) * opt for s, p in pairs)
        total += sum(math.prod(bsh[k].shard_shape(v.shape))
                     * np.dtype(v.dtype).itemsize
                     for k, v in batch.items()) + 4
    elif shape.kind == "prefill":
        total += sum(math.prod(bsh[k].shard_shape(v.shape))
                     * np.dtype(v.dtype).itemsize for k, v in batch.items())
    else:
        cache = JST.abstract_cache(jcfg, shape)
        csh = JSH.cache_shardings(stub, jcfg, shape, cache)
        total += sum(
            math.prod(sh.shard_shape(c.shape)) * np.dtype(c.dtype).itemsize
            for c, sh in zip(jax.tree_util.tree_leaves(cache),
                             jax.tree_util.tree_leaves(csh)))
        total += math.prod(bsh["tokens"].shard_shape(
            batch["tokens"].shape)) * 4
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", BIG)
def test_full_width_plan_bytes_equal_reference_shards(arch, multi_pod,
                                                      monkeypatch):
    """Argument bytes per rank of every cell, plan only (no trace)."""
    for a, s, mp in D.cells(multi_pod):
        if a != arch:
            continue
        cell = D.build_cell(a, s, mp)
        want = _ref_argument_bytes(a, s, mp, monkeypatch)
        assert cell.argument_bytes == want, (s, cell.argument_bytes, want)
        if s == "train_4k":
            sb = cell.plan.state_bytes()
            assert cell.alias_bytes == sb["params"] + sb["moments"]
            # bf16 parameters and two bf16 moments: ~9.3 GB on the pod
            assert 9.0e9 < cell.alias_bytes < 9.5e9 or multi_pod


# --------------------------------------------------------------- tracker
def _real(args, seed=0):
    g = torch.Generator().manual_seed(seed)

    def real(x):
        if not isinstance(x, torch.Tensor):
            return x
        if not x.is_floating_point():
            return torch.randint(0, 100, x.shape, dtype=x.dtype, generator=g)
        return (0.02 * torch.randn(x.shape, generator=g)).to(x.dtype)

    return tree_map(real, args)


def _traced(cell, args):
    with FlopCounterMode(display=False) as fc, LiveBytes(args) as tr:
        cell.step_fn(*args)
    return tr.peak, fc.get_total_flops()


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b", "mamba2-780m",
                                  "seamless-m4t-large-v2"])
def test_tracker_peak_on_meta_equals_cpu(arch, kind):
    cell = D.build(smoke_config(arch), SMOKE_SHAPES[kind], _mesh(1, 1))
    res = D.trace(cell)
    peak, flops = _traced(cell, _real(cell.args))
    assert res["memory"]["temp_size_in_bytes"] == peak > 0
    assert res["flops_rank"] == flops


def test_tracker_counts_views_once_and_frees():
    x = torch.zeros(1000)
    tr = LiveBytes(x)
    with tr:
        y = x + x                       # 4,000 bytes
        views = [y[i:] for i in range(10)]
        z = y + y                       # 4,000 more
        del y, views
        w = z.reshape(10, 100)          # a view of z: nothing new
    assert tr.peak == 8000
    assert tr.live == 4000 and w.numel() == 1000
    assert tr.moved == 3 * 4000 + 3 * 4000


# ------------------------------------------------------- dry vs live
def _tally_shim(tally):
    """Wrap torch.distributed's collectives to count result bytes."""
    import torch.distributed as dist

    def wrap(name, key, result_arg):
        fn = getattr(dist, name)

        def counted(*a, **kw):
            t = tally[key]
            res = a[result_arg]
            t["count"] += 1
            t["bytes"] += res.numel() * res.element_size()
            return fn(*a, **kw)

        setattr(dist, name, counted)

    wrap("all_gather_into_tensor", "all-gather", 0)
    wrap("reduce_scatter_tensor", "reduce-scatter", 0)
    wrap("all_reduce", "all-reduce", 0)


def run_rank(rank, world, root, archs):
    """One rank of a (2, 2) gloo group: one sharded train step per arch,
    its collectives counted; rank 0 writes the tallies."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharded_step import COLLECTIVES, ShardPlan

    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'pg'}",
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(2, device_type="cpu")
        out = {}
        for arch in archs:
            cfg = smoke_config(arch)
            shape = SMOKE_SHAPES["train"]
            plan = ShardPlan(cfg, mesh)
            full = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
            params = tree_map(lambda p: p.requires_grad_(), plan.shard(full))
            m = tree_map(torch.zeros_like, params)
            v = tree_map(torch.zeros_like, params)
            batch = plan.shard_batch(shape, _real(ST.input_specs(cfg,
                                                                 shape)))
            step = ST.make_train_step(cfg, shape, plan=plan)
            tally = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
            saved = {n: getattr(dist, n) for n in (
                "all_gather_into_tensor", "reduce_scatter_tensor",
                "all_reduce")}
            _tally_shim(tally)
            try:
                step(params, m, v, 0, batch)
            finally:
                for n, fn in saved.items():
                    setattr(dist, n, fn)
            out[arch] = tally
        if rank == 0:
            (root / "tally.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


CHILD = """
import json, sys
sys.path[:0] = json.loads(sys.argv[1])
from test_torch_dryrun import run_rank
run_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         json.loads(sys.argv[5]))
"""
LIVE_ARCHS = ["qwen3-8b", "qwen2-0.5b"]


def test_dry_tally_equals_live_gloo_step(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    paths = json.dumps([str(REPO / "src"), str(REPO / "tests")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD), paths, str(r), "4",
         str(tmp_path), json.dumps(LIVE_ARCHS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        errs = [p.communicate(timeout=CHILD_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]
    live = json.loads((tmp_path / "tally.json").read_text())
    for arch in LIVE_ARCHS:
        dry = D.trace(D.build(smoke_config(arch), SMOKE_SHAPES["train"],
                              _mesh(2, 2)))["collectives"]
        assert dry == live[arch], arch
        assert dry["all-gather"]["count"] > 0
        assert dry["all-to-all"] == dry["collective-permute"] == {
            "count": 0, "bytes": 0}
    # the FSDP arch reduce-scatters its gradients over data
    assert live["qwen3-8b"]["reduce-scatter"]["count"] > 0


# ----------------------------------------------------------------- FLOPs
@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
def test_dry_flops_equal_audit_of_the_unsharded_step(kind):
    """(1, 1): the rank's step is the unsharded step; (2, 1): the global
    count is the two data ranks'."""
    cfg = smoke_config("qwen2-0.5b")
    shape = SMOKE_SHAPES[kind]
    params = TM.abstract_params(cfg)
    batch = ST.input_specs(cfg, shape)
    if kind == "train":
        m = tree_map(lambda p: torch.empty_like(p, dtype=torch.float32),
                     params)
        want = audit_step_flops(ST.make_train_step(cfg, shape), params, m,
                                m, 0, batch)
    elif kind == "prefill":
        want = audit_step_flops(ST.make_prefill_step(cfg, shape), params,
                                batch)
    else:
        want = audit_step_flops(ST.make_decode_step(cfg, shape), params,
                                ST.abstract_cache(cfg, shape),
                                batch["tokens"])
    one = D.trace(D.build(cfg, shape, _mesh(1, 1)))
    two = D.trace(D.build(cfg, shape, _mesh(2, 1)))
    assert one["flops_rank"] == one["flops_audit_global"] == want > 0
    assert two["flops_audit_global"] == want == 2 * two["flops_rank"]


# --------------------------------------------------------- serving sites
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_serving_gather_sites_keep_the_bits(arch):
    cfg = smoke_config(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _real(ST.input_specs(cfg, SMOKE_SHAPES["prefill"]), seed=1)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)

    def run():
        with torch.no_grad():
            logits, cache = TM.serve_prefill(params, cfg, batch, max_seq=80)
            steps = [TM.serve_step(params, cfg, cache, tok)[0]
                     for _ in range(3)]
        return [logits] + steps + tree_leaves(cache)

    plain = run()
    sites = []

    def identity(tree, site):
        sites.append(site)
        return tree

    sharding_hooks.set_gather(identity)
    try:
        hooked = run()
    finally:
        sharding_hooks.set_gather(None)
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(plain, hooked))
    n = cfg.n_pattern_repeats
    enc = cfg.n_encoder_layers
    # prefill: each repeat's blocks (+ the cross K/V's, + the encoder's);
    # each decode step: each repeat's blocks and cache
    assert sites.count("blocks") == n * (2 if enc else 1) + 3 * n
    assert sites.count("cache") == 3 * n
    assert sites.count("encoder/blocks") == enc


# ------------------------------------------------------------------- CLI
def test_main_writes_skips_and_forces(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    monkeypatch.setattr(D, "get_arch", smoke_config)
    assert D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"]) == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["qwen2-0.5b__decode_32k__multipod.json",
                     "qwen2-0.5b__decode_32k__pod.json"]
    rec = json.loads((tmp_path / files[1]).read_text())
    assert rec["mesh"] == "pod_16x16" and rec["n_devices"] == 256
    assert set(rec["collectives"]) == {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
    assert rec["memory"]["generated_code_size_in_bytes"] is None
    assert rec["t_compile_s"] == 0.0
    D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
            "pod"])
    assert "[skip] qwen2-0.5b__decode_32k__pod" in capsys.readouterr().out
    D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
            "pod", "--force"])
    assert "[ ok ] qwen2-0.5b__decode_32k__pod" in capsys.readouterr().out
