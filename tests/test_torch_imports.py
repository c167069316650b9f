"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``, nor the port's examples) imports JAX or the JAX package,
every module imports with JAX blocked, and no entry point carries on on the
CPU unless asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "examples" / f"{name}.py" for name in TWINS] + [
        ROOT / "tools" / f"{name}.py" for name in TOOL_TWINS]


TWINS = ("torch_model_accuracy_study", "torch_quickstart",
         "torch_imc_case_study", "torch_variation_study",
         "torch_retention_study", "torch_write_path_study",
         "torch_fault_study", "torch_serving_study", "torch_train_lm",
         "torch_analog_accuracy", "torch_array_mc_sim")
TOOL_TWINS = ("torch_hillclimb", "torch_gen_experiments")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(n)
    assert not bad, f"{path}: imports {bad}"


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert len(mods) >= 55, mods
    for m in ("repro_torch.imc.read_path", "repro_torch.circuit.senseamp",
              "repro_torch.configs.registry", "repro_torch.models.model",
              "repro_torch.models.attention", "repro_torch.models.ssm",
              "repro_torch.models.ffn", "repro_torch.imc.faults",
              "repro_torch.imc.analog_pipeline", "repro_torch.imc.mapping",
              "repro_torch.imc.model_analog", "repro_torch.kernels.bitline_mac",
              "repro_torch.kernels.xnor_gemm",
              "repro_torch.kernels.fake_analog",
              "repro_torch.kernels.llg_write", "repro_torch.configs.olmoe_1b_7b",
              "repro_torch.configs.jamba_1_5_large_398b",
              "repro_torch.imc.cost_model", "repro_torch.launch.traffic",
              "repro_torch.launch.scheduler", "repro_torch.launch.report",
              "repro_torch.launch.simulate", "repro_torch.launch.engine",
              "repro_torch.launch.serve", "repro_torch._tree",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.schedule", "repro_torch.data",
              "repro_torch.data.pipeline", "repro_torch.runtime",
              "repro_torch.runtime.fault", "repro_torch.checkpoint",
              "repro_torch.checkpoint.checkpointer",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.launch.sharding",
              "repro_torch.runtime.elastic", "repro_torch.launch.dryrun",
              "repro_torch.launch.flops_audit",
              "repro_torch.launch.roofline",
              "repro_torch.launch.live_bytes"):
        assert m in mods, m
    code = (
        "import sys\n"
        "for name in ('jax', 'jax.numpy', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('NOJAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NOJAX_OK" in out.stdout


def _entry_points():
    from repro_torch.campaign import CampaignGrid, run_campaign, run_ensemble
    from repro_torch.circuit.subarray import make_subarray
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.device import simulate_write, write_sweep
    from repro_torch.imc.mapping import map_all
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.imc.evaluate import evaluate_system
    from repro_torch.imc.hierarchy import build_hierarchy
    from repro_torch.imc.write_margin import wer_margined_pulse
    from repro_torch.imc import read_path
    from repro_torch.imc.write_path import (WritePolicy,
                                            measured_write_timings,
                                            write_verify,
                                            write_verify_corners)
    from repro_torch.core.params import CORNER_SS, VariationSpec

    grid = CampaignGrid(voltages=(1.0,), pulse_widths=(100e-12,), n_samples=4)
    m0 = torch.zeros(4, 2, 3)
    return {
        "run_ensemble": lambda: run_ensemble(AFMTJ_PARAMS, m0, torch.ones(4),
                                             1e-13, 10),
        "run_campaign": lambda: run_campaign(AFMTJ_PARAMS, grid,
                                             use_cache=False),
        "wer_margined_pulse": lambda: wer_margined_pulse("afmtj",
                                                         use_cache=False),
        "write_verify": lambda: write_verify(
            "afmtj", 4, WritePolicy(pulse=1e-10, use_cache=False)),
        "write_verify_nominal": lambda: write_verify(
            "afmtj", 4, WritePolicy(use_cache=False)),
        "measured_write_timings": lambda: measured_write_timings(
            "afmtj", cols=4, n_rows=1, use_cache=False),
        "simulate_write": lambda: simulate_write(AFMTJ_PARAMS, 1.0,
                                                 n_steps=10),
        "write_sweep": lambda: write_sweep(AFMTJ_PARAMS, [0.5, 1.0],
                                           n_steps=10),
        "map_all": lambda: map_all(ARCHS),
        "torch_quickstart.run": lambda: _twin("torch_quickstart").run(
            afmtj_steps=10, mtj_steps=10),
        "torch_imc_case_study.run": lambda: _twin(
            "torch_imc_case_study").run(),
        "simulate_write_corner": lambda: simulate_write(
            AFMTJ_PARAMS, 1.0, n_steps=10,
            variation=VariationSpec(corners=(CORNER_SS,)).sample_device(
                AFMTJ_PARAMS)),
        "write_verify_corners": lambda: write_verify_corners(
            "afmtj", 4, WritePolicy(pulse=1e-10, use_cache=False),
            VariationSpec(corners=(CORNER_SS,))),
        "read_disturb_campaign": lambda: read_path.read_disturb_campaign(
            n_samples=4, use_cache=False),
        "retention_campaign": lambda: read_path.retention_campaign(
            n_samples=4, use_cache=False),
        "fit_disturb_model": lambda: read_path.fit_disturb_model(
            n_samples=4, use_cache=False),
        "sense_margin_yield": lambda: read_path.sense_margin_yield(
            n_samples=4),
        "measured_read_timings": lambda: read_path.measured_read_timings(
            "afmtj", n_samples=4),
        "derive_refresh_policy": lambda: read_path.derive_refresh_policy(
            n_samples=4, use_cache=False),
        "torch_variation_study.run": lambda: _twin(
            "torch_variation_study").run(quick=True, use_cache=False),
        "torch_retention_study.run": lambda: _twin(
            "torch_retention_study").run(quick=True, use_cache=False),
        "make_subarray": lambda: make_subarray("afmtj"),
        "build_hierarchy": lambda: build_hierarchy("afmtj"),
        "evaluate_system": lambda: evaluate_system("afmtj"),
        **_analog_entry_points(),
        **_remainder_entry_points(),
        **_training_entry_points(),
    }


def _training_entry_points():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    shape = ShapeConfig("t", "train", 8, 2)
    return {
        "train": lambda: train.train(smoke_config("qwen2-0.5b"), shape,
                                     AdamWConfig(), 1, "unused-ckpt-dir"),
        "train.main": lambda: train.main(["--arch", "qwen2-0.5b",
                                          "--steps", "1"]),
        "torch_train_lm.main": lambda: _twin("torch_train_lm").main(
            ["--steps", "1"]),
    }


def _remainder_entry_points():
    import numpy as np

    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.core import montecarlo
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.imc import cost_model, mapping, write_path
    from repro_torch.launch import engine, serve, simulate

    pol = write_path.WritePolicy(pulse=1e-10, use_cache=False)
    return {
        "write_error_rate": lambda: montecarlo.write_error_rate(
            AFMTJ_PARAMS, 1.0, 1e-11, n_samples=4),
        "write_error_rate_scan": lambda: montecarlo.write_error_rate_scan(
            AFMTJ_PARAMS, 1.0, 1e-12, n_samples=4),
        "program_bits": lambda: write_path.program_bits(
            np.ones((2, 2), int), policy=pol),
        "write_surface": lambda: write_path.write_surface(
            "afmtj", n_cells=4, policy=pol),
        "write_energy_accuracy_surface": lambda:
            mapping.write_energy_accuracy_surface(
                get_arch("qwen2-0.5b"), policy=pol, n_cells=4),
        "imc_cost_model": lambda: cost_model.imc_cost_model("afmtj"),
        "device_cost_model": lambda: cost_model.device_cost_model("mtj"),
        "fault_slo_curve": lambda: simulate.fault_slo_curve(n_requests=8),
        "ServeEngine": lambda: engine.ServeEngine(
            smoke_config("qwen2-0.5b"), 4, 2, 1),
        "ServeEngine_mamba": lambda: engine.ServeEngine(
            smoke_config("mamba2-780m"), 4, 2, 1),
        "serve.main": lambda: serve.main(["--requests", "1"]),
        "torch_write_path_study.run": lambda: _twin(
            "torch_write_path_study").run(quick=True),
        "torch_fault_study.run": lambda: _twin(
            "torch_fault_study").run(quick=True),
        "torch_serving_study.run": lambda: _twin(
            "torch_serving_study").run(quick=True),
        "torch_analog_accuracy.run": lambda: _twin(
            "torch_analog_accuracy").run(caps=dict(cap_k=8, cap_n=8,
                                                   batch=1)),
        "torch_array_mc_sim.run": lambda: _twin("torch_array_mc_sim").run(
            rows=1, cols=4, n_steps=10, use_cache=False),
        "torch_fault_study.resume_demo": lambda: _twin(
            "torch_fault_study").resume_demo(),
    }


def _twin(name):
    """The example twin ``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _analog_entry_points():
    import numpy as np

    from repro_torch.configs.registry import smoke_config
    from repro_torch.imc import analog_pipeline as ap
    from repro_torch.imc import mapping, model_analog as ma

    w = np.ones((8, 4), np.float32)
    x = np.ones((2, 8), np.float32)
    cfg = smoke_config("qwen2-0.5b")
    params = ma.init_model_params(cfg, 0, "cpu")
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    return {
        "program_weights": lambda: ap.program_weights(w),
        "binary_matmul": lambda: ap.binary_matmul(x, w),
        "mvm_accuracy": lambda: ap.mvm_accuracy(w, x),
        "fake_analog_matmul": lambda: ma.fake_analog_matmul(w, x),
        "program_weights_cached": lambda: ma.program_weights_cached(w),
        "analog_model_logits": lambda: ma.analog_model_logits(params, cfg,
                                                              tokens),
        "model_accuracy": lambda: ma.model_accuracy(batch=1, seq_len=4),
        "model_accuracy_surface": lambda: ma.model_accuracy_surface(
            batch=1, seq_len=4),
        "model_degradation_curves": lambda: ma.model_degradation_curves(
            batch=1, seq_len=4),
        "decode_projection_accuracy": lambda: mapping.decode_projection_accuracy(
            cfg),
        "accuracy_surface": lambda: mapping.accuracy_surface(cfg),
    }


@pytest.mark.parametrize("name", sorted([
    "run_ensemble", "run_campaign", "wer_margined_pulse", "write_verify",
    "write_verify_nominal", "measured_write_timings", "simulate_write",
    "write_sweep", "map_all", "torch_quickstart.run",
    "torch_imc_case_study.run", "simulate_write_corner",
    "write_verify_corners", "read_disturb_campaign", "retention_campaign",
    "fit_disturb_model", "sense_margin_yield", "measured_read_timings",
    "derive_refresh_policy", "torch_variation_study.run",
    "torch_retention_study.run",
    "make_subarray", "build_hierarchy", "evaluate_system",
    "program_weights", "binary_matmul", "mvm_accuracy", "fake_analog_matmul",
    "program_weights_cached", "analog_model_logits", "model_accuracy",
    "model_accuracy_surface", "model_degradation_curves",
    "decode_projection_accuracy", "accuracy_surface",
    "write_error_rate", "write_error_rate_scan", "program_bits",
    "write_surface", "write_energy_accuracy_surface", "imc_cost_model",
    "device_cost_model", "fault_slo_curve", "ServeEngine",
    "ServeEngine_mamba", "serve.main",
    "torch_write_path_study.run", "torch_fault_study.run",
    "torch_serving_study.run", "train", "train.main",
    "torch_train_lm.main", "torch_analog_accuracy.run",
    "torch_array_mc_sim.run", "torch_fault_study.resume_demo"]))
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_kernel_wrapper_rejects_other_devices():
    from repro_torch.core.params import AFMTJ_PARAMS
    from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
    from repro_torch.kernels.llg_write import llg_write_kernel

    with pytest.raises(ValueError):
        llg_rk4_kernel(torch.zeros(8, 512, device="meta"), AFMTJ_PARAMS,
                       1e-13, 1)
    with pytest.raises(ValueError):
        llg_write_kernel(torch.zeros(1, 2, 3, device="meta"),
                         torch.ones(1, device="meta"), AFMTJ_PARAMS, 1e-13, 1)
