"""The benchmark's own files on the CPU: every name of BENCHMARK.json
resolves to its files, the harness and the reference import neither JAX
nor the JAX package (the reference nothing of the program either), the
command refuses to run without a card, and the frozen FLOP counts agree
with the program's audit."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import flops, registry, smoke  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    c = registry.Cell(cell)
    assert c.chips == 1
    assert (registry.TRAFFIC / f"{c.traffic_name}.json").is_file()
    assert (registry.DRIVERS / f"{c.traffic['driver']}.py").is_file()
    drv = c.driver()
    for fn in ("setup", "window", "end_to_end", "check", "control_readings",
               "program_readings"):
        assert callable(getattr(drv, fn)), fn
    assert c.limits() and all(v >= 0.0 for v in c.limits().values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(registry.Cell(SPEC["workloads"][0]["name"]).reader(
        metric).read)


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
    if path.parent.name == "reference":
        assert not tops & {"repro_torch", "benchlib"}, path


def test_forbidden_modules_by_whole_top_level_name():
    from benchlib import harness

    names = ["repro_torch.imc", "reprox", "jaxtyping", "torch", "repro.core"]
    assert harness.loaded_forbidden(names) == ["repro"]
    assert harness.loaded_forbidden(names + ["jax._src", "flax"]) == [
        "flax", "jax", "repro"]


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_forward_flops_equal_the_audit():
    """The surface's model FLOPs (dense model) are the program's exact
    forward counted by ``FlopCounterMode``."""
    import torch

    from repro_torch.imc import model_analog as ma
    from repro_torch.launch.flops_audit import audit_step_flops
    from repro_torch.models import model as TM

    cfg = smoke.smoke_configs()["qwen2-0.5b"]
    conf = smoke.smoke_cell("qwen2-0.5b.surface-4k").config
    tokens = torch.empty((4, 64), dtype=torch.int64, device="meta")
    got = audit_step_flops(lambda p, t: ma.model_forward_logits(p, cfg, t),
                           TM.abstract_params(cfg), tokens)
    assert got == flops.forward_flops(conf, 4, 64)


def test_train_flops_bound_the_audit():
    """The training step's audit counts the model FLOPs (6 N T + 12 L h hd
    S T) plus its recompute, which is at most one more forward."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch.flops_audit import audit_step_flops
    from repro_torch.models import model as TM

    cfg = smoke.smoke_configs()["qwen2-0.5b"]
    conf = smoke.smoke_cell("qwen2-0.5b.train-4k").config
    shape = ShapeConfig("t", "train", 64, 4, microbatches=2)
    params = TM.abstract_params(cfg)
    got = audit_step_flops(ST.make_train_step(cfg, shape), params, params,
                           params, 0, ST.input_specs(cfg, shape))
    model = flops.train_flops(conf, flops.matmul_params(conf, True), 4, 64)
    assert model < got <= model + flops.forward_flops(conf, 4, 64)


def test_analog_shapes_cover_every_routed_linear():
    conf = registry.Cell("qwen2-0.5b.surface-4k").config
    assert sum(c for _, _, c in flops.analog_shapes(conf)) == 24 * 7 + 1
    conf = registry.Cell("olmoe-1b-7b.surface-4k").config
    assert sum(c for _, _, c in flops.analog_shapes(conf)) == 16 * 4 + 1
