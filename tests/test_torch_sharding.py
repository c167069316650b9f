"""The port's sharding plans against the reference's, on the CPU, without
collectives: ``resolve_pspec`` (the cases of ``tests/test_mesh_sharding.py``
and ``tests/test_substrate.py``), the parameter spec trees of all ten archs
(smoke configs, and the published configs on the meta device) on meshes
(1, 1), (2, 2), (16, 16) and (2, 16, 16) for training and serving, with
and without each environment knob, the batch and decode-cache specs per
leaf, ``abstract_params`` / ``logical_axes``, ``shape_for``,
``input_specs`` / ``abstract_cache``, the model meshes' checks, the
collective profiles (counterparts of ``tests/test_mesh_sharding.py``'s
``xla_flags`` tests) and the shard regions of a plan.

The reference's ``param_rules`` and ``resolve_pspec`` read only a mesh's
``axis_names`` and ``devices.shape``, so they get a stub with those; its
batch / cache shardings wrap each spec in ``NamedSharding``, replaced here
by the spec itself.  Specs compare as ``tuple(PartitionSpec(...))``.
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as JB
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import smoke_config as j_smoke
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch._tree import dict_leaves, map_dict
from repro_torch.configs import base as TB
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (MeshShape, data_axes, make_local_mesh,
                                     make_production_mesh,
                                     production_mesh_shape)
from repro_torch.launch.sharded_step import ShardPlan, elastic_remesh
from repro_torch.models import model as TM
from repro_torch.runtime import xla_flags

ARCH_NAMES = sorted(J_ARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KNOBS = {"none": {}, "attn_dp": "REPRO_ATTN_DP_ARCHS",
         "full_dp": "REPRO_FULL_DP_ARCHS",
         "serve_tp": {"REPRO_SERVE_WEIGHT_AXES": "tp"}}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


class StubMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=np.int8)


def _meshes(name):
    shape, names = MESHES[name]
    return StubMesh(shape, names), MeshShape(names, shape)


@functools.lru_cache(maxsize=None)
def _configs(arch, preset):
    if preset == "smoke":
        return j_smoke(arch), smoke_config(arch)
    return J_ARCHS[arch], get_arch(arch)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _ref_specs(jcfg, stub, kind):
    rules = JSH.param_rules(jcfg, stub, kind)
    return jax.tree_util.tree_map(
        lambda ax, sds: tuple(JSH.resolve_pspec(sds.shape, ax, rules, stub)),
        JM.logical_axes(jcfg), JM.abstract_params(jcfg), is_leaf=_is_axes)


# ------------------------------------------------------------ resolve_pspec
RULES = {"embed": ("data",), "ffn": ("model",), "both": ("data", "model"),
         "vocab": ("model",)}
PSPEC_CASES = [
    ("2x2", (8, 6), ("embed", "ffn"), ("data", "model")),
    ("2x2", (7, 6), ("embed", "ffn"), (None, "model")),
    ("2x2", (8,), ("both",), (("data", "model"),)),
    ("2x2", (6,), ("both",), (None,)),
    ("2x2", (8, 8), ("embed", "embed"), ("data", None)),
    ("1x1", (100, 64), ("vocab", "embed"), ("model", "data")),
    ("2x2", (100, 64), ("vocab", "embed"), ("model", "data")),
    ("16x16", (151936, 896), ("vocab", "embed"), ("model", "data")),
    ("16x16", (256206, 1024), ("vocab", "embed"), (None, "data")),
    ("2x16x16", (512, 3), ("both", None), (("data", "model"), None)),
    ("2x16x16", (64, 3), ("both", None), (None, None)),
]


@pytest.mark.parametrize("mesh,shape,axes,want", PSPEC_CASES)
def test_resolve_pspec_cases(mesh, shape, axes, want):
    """Dividing dims map to their mesh axes, others drop to replicated, a
    multi-axis rule needs the product to divide, an axis serves one dim."""
    stub, ms = _meshes(mesh)
    got = SH.resolve_pspec(shape, axes, RULES, ms)
    assert got == want
    assert got == tuple(JSH.resolve_pspec(shape, axes, RULES, stub))


# ------------------------------------------------------------- spec trees
@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("preset", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_tree_matches_reference(arch, preset, mesh, kind, knob,
                                           monkeypatch):
    jcfg, cfg = _configs(arch, preset)
    env = KNOBS[knob]
    for k, v in ({env: cfg.name} if isinstance(env, str) else env).items():
        monkeypatch.setenv(k, v)
    stub, ms = _meshes(mesh)
    want = _ref_specs(jcfg, stub, kind)
    got = SH.param_shardings(cfg, ms, TM.logical_axes(cfg),
                             TM.abstract_params(cfg), kind)
    assert got == want


@pytest.mark.parametrize("preset", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_and_axes_match_reference(arch, preset):
    """Meta tensors with the reference's shapes and dtypes; the logical
    axes equal."""
    jcfg, cfg = _configs(arch, preset)
    ja = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                JM.abstract_params(jcfg))
    ta = TM.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in dict_leaves(ta))
    assert map_dict(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                    ta) == ja
    assert TM.logical_axes(cfg) == jax.tree_util.tree_map(
        lambda x: x, JM.logical_axes(jcfg), is_leaf=_is_axes)


# ------------------------------------------------- batch / cache / shapes
@pytest.fixture
def named_is_spec(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: tuple(spec))


def _shape(name):
    s = JB.shape_for(None, name, 4 if name == "train_4k" else None)
    return s, TB.shape_for(None, name, 4 if name == "train_4k" else None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_batch_and_cache_specs_match_reference(arch, shape_name, mesh,
                                               named_is_spec):
    jcfg, cfg = _configs(arch, "full")
    js, ts = _shape(shape_name)
    stub, ms = _meshes(mesh)
    jb = JSH.batch_shardings(stub, js, JST.input_specs(jcfg, js))
    assert SH.batch_shardings(ms, ts, ST.input_specs(cfg, ts)) == jb
    if js.kind == "train":
        return
    jc = JSH.cache_shardings(stub, jcfg, js, JST.abstract_cache(jcfg, js))
    tc = SH.cache_shardings(ms, cfg, ts, ST.abstract_cache(cfg, ts))
    assert tc.pop("max_seq") == ()
    assert tc == jc


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_and_abstract_cache_match_reference(arch, shape_name):
    jcfg, cfg = _configs(arch, "full")
    js, ts = _shape(shape_name)
    assert ts == TB.ShapeConfig(js.name, js.kind, js.seq_len,
                                js.global_batch, js.microbatches)
    ji = {k: (tuple(v.shape), str(v.dtype))
          for k, v in JST.input_specs(jcfg, js).items()}
    ti = ST.input_specs(cfg, ts)
    assert all(v.device.type == "meta" for v in ti.values())
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in ti.items()} == ji
    if js.kind == "train":
        return
    jc = JST.abstract_cache(jcfg, js)
    tc = ST.abstract_cache(cfg, ts)
    assert tc.pop("max_seq") == js.seq_len and tc.pop("pos") == 0
    jc.pop("pos")

    def sig(t):
        return tuple(t.shape), str(t.dtype).split(".")[-1]

    assert jax.tree_util.tree_map(sig, tc) == jax.tree_util.tree_map(sig, jc)


def test_shape_for_matches_reference():
    for name in JB.SHAPES:
        for mb in (None, 8):
            j = JB.shape_for(None, name, mb)
            t = TB.shape_for(None, name, mb)
            assert (t.name, t.kind, t.seq_len, t.global_batch,
                    t.microbatches) == (j.name, j.kind, j.seq_len,
                                        j.global_batch, j.microbatches)


# ------------------------------------------------------------------ meshes
def test_production_mesh_shape_and_data_axes():
    ms = production_mesh_shape()
    assert (ms.axis_names, ms.shape) == (("data", "model"), (16, 16))
    mp = production_mesh_shape(multi_pod=True)
    assert (mp.axis_names, mp.shape) == (("pod", "data", "model"),
                                         (2, 16, 16))
    assert data_axes(ms) == ("data",) and data_axes(mp) == ("pod", "data")


def test_model_meshes_on_one_rank(tmp_path):
    """Without a process group a model mesh raises; on a 1-rank gloo group
    the local mesh is (1, 1) and the production mesh refuses the world."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_local_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device_type="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="model axis 2"):
            make_local_mesh(model=2, device_type="cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = xla_flags.apply_profile("gpu-scaling")
        assert any(issubclass(x.category, RuntimeWarning) for x in w)
        assert out == dict(__import__("os").environ)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ collective profiles
def test_flags_for_gpu_scaling_profile():
    s = xla_flags.flags_for("gpu-scaling")
    assert "TORCH_NCCL_HIGH_PRIORITY=1" in s
    assert len(s.split()) == len(xla_flags.PROFILES["gpu-scaling"])


def test_host_devices_has_no_counterpart():
    with pytest.raises(KeyError, match=r"devices=\['cpu'\] \* n"):
        xla_flags.flags_for("host-devices", n=8)
    with pytest.raises(KeyError, match="no torch counterpart"):
        xla_flags.apply_profile("host-devices", {}, n=4)


def test_flags_for_unknown_profile_raises():
    with pytest.raises(KeyError, match="unknown profile"):
        xla_flags.flags_for("nope")


def test_apply_profile_merges_preserving_existing_settings():
    env = {"TORCH_NCCL_HIGH_PRIORITY": "0", "OTHER": "x"}
    out = xla_flags.apply_profile("gpu-scaling", env)
    assert out == env and out is not env
    out2 = xla_flags.apply_profile("gpu-scaling", {"OTHER": "x"})
    assert out2 == {"OTHER": "x", "TORCH_NCCL_HIGH_PRIORITY": "1"}


# ------------------------------------------------------------- shard plans
@pytest.mark.parametrize("mesh", ["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-8b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_shard_regions_tile_every_leaf(arch, mesh):
    """Over every rank's coordinate the shard regions of each leaf (smoke
    config) cover each element once per replica, and every rank's bytes
    are the plan's ``state_bytes``."""
    _, cfg = _configs(arch, "smoke")
    _, ms = _meshes(mesh)
    coords = list(np.ndindex(*ms.shape))
    plans = [ShardPlan(cfg, ms, c) for c in coords[:: max(1, len(coords)
                                                            // 16)]]
    full = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = plans[0].state_bytes()
    opt = {"float32": 4, "bfloat16": 2}[cfg.opt_state_dtype]
    for plan in plans:
        local = dict_leaves(plan.shard(full))
        assert want == {"params": sum(t.nbytes for t in local),
                        "moments": 2 * opt * sum(t.numel() for t in local)}
    if len(coords) > 16:
        return
    for x, spec in zip(dict_leaves(full), dict_leaves(plans[0].specs)):
        seen = torch.zeros(x.shape, dtype=torch.int32)
        for c in coords:
            seen[SH.shard_region(tuple(x.shape), spec, ms,
                                 dict(zip(ms.axis_names, c)))] += 1
        shards = int(np.prod([dict(zip(ms.axis_names, ms.shape))[a]
                              for e in spec for a in SH.spec_axes(e)]))
        assert bool((seen == len(coords) // shards).all())


def test_state_bytes_of_qwen2_on_the_pod_mesh():
    """qwen2-0.5b (tp: vocab, heads and ffn over model 16) on (16, 16)."""
    cfg = get_arch("qwen2-0.5b")
    plan = ShardPlan(cfg, production_mesh_shape(), (0, 0))
    total = sum(int(np.prod(t.shape)) for t in
                dict_leaves(TM.abstract_params(cfg)))
    b = plan.state_bytes()
    assert total * 4 / 16 <= b["params"] < total * 4 / 2
    assert b["moments"] == 2 * b["params"]


def test_elastic_remesh_keeps_the_global_batch():
    shape = TB.ShapeConfig("t", "train", 1024, 4, microbatches=2)
    ms, new = elastic_remesh(2, MeshShape(("data", "model"), (2, 2)), shape)
    assert (ms.axis_names, ms.shape) == (("data", "model"), (1, 2))
    assert new.microbatches == 4 and new.global_batch == 4
    assert elastic_remesh(1, MeshShape(("data", "model"), (2, 2)),
                          shape) is None
