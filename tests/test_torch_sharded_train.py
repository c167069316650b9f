"""The sharded trainer and its checkpoints on gloo ranks of this CPU:
``launch.train.train(..., mesh=)`` saves one payload per rank
(``ShardedCheckpointer``), restores onto any mesh, and resumes on the
degraded mesh of ``sharded_step.elastic_remesh``; ``main --mesh`` on one
rank equals the one-device CLI.

Children are ``python -c`` processes with a ``file://`` rendezvous under
the test's temporary directory.  qwen3-8b's smoke config is the model:
its embed axis is split over ``data`` (an ``FSDP_ARCHS`` prefix match)
and its heads, ffn and vocabulary over ``model``, so every leaf kind is
resharded.

* A checkpoint saved on (2, 2) restores bit for bit: each (2, 2) rank's
  shards equal its payload's, and the (1, 2) and (1, 1) restores are the
  same full tensors cut as those meshes cut them.
* The (2, 2) run's step-2 checkpoint resumed on (1, 2) (microbatches 2 ->
  4, the global batch kept) takes step 3 like the uninterrupted (2, 2)
  run: loss rtol 1e-6, parameters max |d| <= 1e-5, moments 1e-4 of each
  leaf's largest |value| (``tests/test_torch_sharded_step.py``'s bounds).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch._tree import dict_leaves
from repro_torch.checkpoint import ShardedCheckpointer
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharded_step import ShardPlan, elastic_remesh
from repro_torch.launch.train import main
from repro_torch.models import model as TM

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen3-8b"
B, S, MICRO = 4, 32, 2
CHILD_TIMEOUT_S = 300


def train_rank(rank, world, mesh_shape, root, ckpt_dir, steps, micro):
    """One rank of ``train`` on a (data, model) mesh; rank 0 writes the
    logged steps."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig

    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(mesh_shape[1], device_type="cpu")
        hist = train(smoke_config(ARCH),
                     ShapeConfig("t", "train", S, B, microbatches=micro),
                     AdamWConfig(lr=1e-2), steps, ckpt_dir, save_every=1,
                     log_every=1, device="cpu", mesh=mesh, total_steps=10)
        if rank == 0:
            Path(root, "hist.json").write_text(json.dumps(
                [[r.step, r.loss, r.grad_norm] for r in hist]))
    finally:
        dist.destroy_process_group()


CHILD = """
import json, sys
sys.path[:0] = json.loads(sys.argv[1])
from test_torch_sharded_train import train_rank
a = json.loads(sys.argv[2])
train_rank(*a)
"""


def _run(mesh, root: Path, ckpt_dir, steps, micro):
    root.mkdir(parents=True)
    world = mesh[0] * mesh[1]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    paths = json.dumps([str(REPO / "src"), str(REPO / "tests")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD), paths, json.dumps(
            [r, world, list(mesh), str(root), str(ckpt_dir), steps,
             micro])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=CHILD_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]
    return json.loads((root / "hist.json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(2, 2) for 3 steps saving every step; its step-2 checkpoint resumed
    on the elastic plan's mesh for step 3."""
    root = tmp_path_factory.mktemp("sharded_train")
    shape = ShapeConfig("t", "train", S, B, microbatches=MICRO)
    new_mesh, new_shape = elastic_remesh(2, MeshShape(("data", "model"),
                                                      (2, 2)), shape)
    a = _run((2, 2), root / "a", root / "ck_a", 3, MICRO)
    src = root / "ck_a" / smoke_config(ARCH).name
    dst = root / "ck_b" / smoke_config(ARCH).name
    dst.mkdir(parents=True)
    shutil.copytree(src / "step_2", dst / "step_2")
    b = _run(new_mesh.shape, root / "b", root / "ck_b", 3,
             new_shape.microbatches)
    return {"a": a, "b": b, "ck_a": src, "ck_b": dst,
            "mesh_b": new_mesh, "micro_b": new_shape.microbatches}


def _like():
    cfg = smoke_config(ARCH)
    p = TM.abstract_params(cfg)
    return {"params": p, "m": p, "v": p, "step": torch.empty(())}


def _restore(ck, step, mesh: MeshShape, coord):
    plan = ShardPlan(smoke_config(ARCH), mesh, coord)
    return plan, ShardedCheckpointer(ck, plan).restore(step, _like(),
                                                       device="cpu")


def test_checkpoint_has_one_payload_per_rank(runs):
    d = runs["ck_a"] / "step_2"
    man = json.loads((d / "manifest.json").read_text())
    assert man["mesh"] == {"axis_names": ["data", "model"], "shape": [2, 2]}
    assert man["host_count"] == 4
    assert sorted(p.name for p in d.glob("host*.pt")) == [
        f"host{r}.pt" for r in range(4)]
    assert not list(runs["ck_a"].glob("*.tmp"))


@pytest.mark.parametrize("step", [2, 3])
def test_restore_on_four_two_and_one_rank_is_bit_equal(runs, step):
    ck = runs["ck_a"]
    _, full = _restore(ck, step, MeshShape(("data", "model"), (1, 1)),
                       (0, 0))
    full_leaves = dict_leaves(full)
    for shape in ((2, 2), (1, 2)):
        mesh = MeshShape(("data", "model"), shape)
        for coord in [(i, j) for i in range(shape[0])
                      for j in range(shape[1])]:
            plan, got = _restore(ck, step, mesh, coord)
            specs = ShardedCheckpointer(ck, plan).specs_of(_like())
            c = dict(zip(mesh.axis_names, coord))
            for x, f, spec in zip(dict_leaves(got), full_leaves,
                                  dict_leaves(specs)):
                assert torch.equal(x, f[SH.shard_region(
                    tuple(f.shape), spec, mesh, c)])
    # each (2, 2) rank's payload holds its own shards, bit for bit
    for r in range(4):
        payload = torch.load(ck / f"step_{step}" / f"host{r}.pt")
        coord = divmod(r, 2)
        _, got = _restore(ck, step, MeshShape(("data", "model"), (2, 2)),
                          coord)
        flat = dict(zip(_paths(got), dict_leaves(got)))
        assert payload and all(torch.equal(v, flat[k])
                               for k, v in payload.items())
    assert int(full["step"]) == step


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in
                _paths(tree[k], f"{pre}{k}/")]
    return [pre[:-1]]


def test_resume_on_the_degraded_mesh_matches_the_uninterrupted_run(runs):
    a, b = runs["a"], runs["b"]
    assert [r[0] for r in a] == [0, 1, 2] and [r[0] for r in b] == [2]
    assert runs["mesh_b"].shape == (1, 2) and runs["micro_b"] == 4
    assert b[0][1] == pytest.approx(a[2][1], rel=1e-6)
    _, sa = _restore(runs["ck_a"], 3, MeshShape(("data", "model"), (1, 1)),
                     (0, 0))
    _, sb = _restore(runs["ck_b"], 3, MeshShape(("data", "model"), (1, 1)),
                     (0, 0))
    for k in ("params", "m", "v"):
        for x, y in zip(dict_leaves(sb[k]), dict_leaves(sa[k])):
            d = (x.double() - y.double()).abs().max().item()
            bound = 1e-5 if k == "params" else \
                1e-4 * y.double().abs().max().item()
            assert d <= bound or d == 0.0, (k, d)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_with_a_one_rank_mesh_equals_the_one_device_cli(
        tmp_path, monkeypatch):
    """``main --mesh 1,1`` (a 1-rank gloo group from the launcher's
    environment) logs the one-device CLI's losses bit for bit and writes
    a sharded checkpoint."""
    args = ["--arch", "qwen2-0.5b", "--steps", "4", "--batch", "4", "--seq",
            "32", "--microbatches", "2", "--save-every", "2",
            "--log-every", "1", "--device", "cpu", "--lr", "1e-2"]
    one = main(args + ["--ckpt-dir", str(tmp_path / "one")])
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    meshed = main(args + ["--ckpt-dir", str(tmp_path / "mesh"),
                          "--mesh", "1,1"])
    assert meshed == one and len(one) == 4
    man = json.loads((tmp_path / "mesh" / "qwen2-0.5b-smoke" / "step_4" /
                      "manifest.json").read_text())
    assert man["mesh"]["shape"] == [1, 1]
    with pytest.raises(ValueError, match="needs 4 ranks"):
        main(args + ["--ckpt-dir", str(tmp_path / "bad"), "--mesh", "2,2"])
