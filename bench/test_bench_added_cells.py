"""The hybrid cell (``granite-4.0-h-small.surface-2k``) at smoke size on
the CPU: a whole run of the harness is correct with the cell's own limits,
the control and every planted fault fail it, the new readers resolve (the
Mamba reader's correlation of kernels to launches on synthetic events),
the hybrid FLOP count equals the program's audit with the capacity slots
apart, and the hybrid weights are the program's parameter tree."""
import copy
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchlib import faults, harness, hybrid_flops, hybrid_weights  # noqa: E402
from benchlib.registry import Cell  # noqa: E402
from reference import hybrid  # noqa: E402

HYBRID = "granite-4.0-h-small.surface-2k"
SMOKE = {"batch": 2, "seq_len": 32, "sample_rows": 16}
CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def smoke_archs() -> dict:
    """Both tables' smoke configs (``smoke.smoke_configs`` holds only the
    reference's ten)."""
    from repro_torch.configs import registry

    return {n: registry.smoke_config(n)
            for n in list(registry.ARCHS) + list(registry.PORT_ARCHS)}


def hybrid_conf(conf: dict, c) -> dict:
    """The hybrid configuration file at the program's smoke sizes ``c``."""
    conf = copy.deepcopy(conf)
    conf.update(
        hidden_size=c.d_model, num_attention_heads=c.n_heads,
        num_key_value_heads=c.n_kv_heads, head_dim=c.d_head,
        intermediate_size=c.moe.d_expert,
        shared_intermediate_size=c.shared_width,
        num_local_experts=c.moe.num_experts,
        num_experts_per_tok=c.moe.top_k,
        mamba_n_heads=c.ssm.expand * c.d_model // c.ssm.headdim,
        mamba_d_head=c.ssm.headdim, mamba_d_state=c.ssm.d_state,
        mamba_chunk_size=c.ssm.chunk, mamba_d_conv=c.ssm.d_conv,
        vocab_size=c.vocab)
    conf["precision"] = dict(conf["precision"], compute_dtype=c.compute_dtype,
                             param_dtype=c.param_dtype)
    return conf


def smoke_cell(name: str = HYBRID) -> Cell:
    cell = Cell(name)
    cell.config = hybrid_conf(cell.config,
                              smoke_archs()[cell.config["program_arch"]])
    cell.traffic = dict(cell.traffic, **SMOKE)
    return cell


@pytest.fixture
def program(monkeypatch):
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_arch", smoke_archs().__getitem__)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def execute(seed=2 ** 31 + 7, trace=False):
    return harness.execute(smoke_cell(), seed, 0.5, trace, CPU,
                           time.perf_counter())


def test_run_is_correct(program):
    out = execute()
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"surface_tokens_per_s", "point_ms_p90",
                                   "setup_s"}


def test_traced_run_calls_every_reader(program):
    """A traced run calls each of the cell's readers; on the CPU, with no
    device work in the trace, each reads nothing and the run is correct."""
    out = execute(trace=True)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) <= {m["name"] for m in
                                   smoke_cell().per_layer}


def test_control_fails(program):
    c = smoke_cell()
    limits = c.limits()
    for seed in (3, 4):
        run = harness.Run(c, seed, 0.0, False, CPU, 0.0)
        got = c.driver().control_readings(run)
        assert any(got[k] > lim for k, lim in limits.items()), got


@pytest.mark.parametrize("fault", faults.SURFACE)
def test_fault_fails(program, fault):
    with faults.plant("surface", fault, smoke_cell().config):
        out = execute(seed=11)
    assert not out["correct"], (fault, out["checks"])


def test_every_hybrid_product_kept(program):
    """All 35 products a forward routes through the crossbar at the
    published layout (4 attention, 3 x 10 shared expert, the unembed), each
    kept, judged, and every layer between them followed."""
    c = smoke_cell()
    run = harness.Run(c, 5, 0.0, False, CPU, 0.0)
    got = c.driver().program_readings(run)
    assert got["missing_outputs"] == 0.0
    arch = hybrid.Arch(c.config)
    assert len(hybrid.sites(arch)) == 35
    assert all(set(run.outputs["sites"][k]) == set(hybrid.sites(arch))
               for k in run.sampled)
    for name, limit in c.limits().items():
        assert got[name] <= limit, (name, got)


@pytest.mark.parametrize("metric", ["mamba_ms.surface", "mfu.surface_hybrid",
                                    "analog_roofline.surface_hybrid"])
def test_new_reader_resolves(metric):
    assert callable(Cell(HYBRID).reader(metric).read)


class _Event:
    def __init__(self, name, host, start, dur, corr, kind):
        self._v = (name, host, start, dur, corr, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[1]
                else torch.autograd.DeviceType.CUDA)

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


class _UntypedEvent(_Event):
    """An event of a profiler that gives no activity type (PyTorch 2.11)."""
    activity_type = None


@pytest.mark.parametrize("typed", [True, False])
def test_mamba_reader_links_kernels_to_launches_in_the_span(typed):
    """Kernels count by their launch's correlation id, whenever they run;
    a CPU operator's id, a launch outside the span, a span outside the
    window and the device's mirror of the span do not count, with or
    without the events' activity types."""
    read = Cell(HYBRID).reader("mamba_ms.surface")
    cls = _Event if typed else _UntypedEvent
    ev = [cls("repro.mamba", True, 100, 50, 1, "user_annotation"),
          cls("cudaLaunchKernel", True, 110, 5, 7, "cuda_runtime"),
          cls("aten::mm", True, 112, 5, 8, "cpu_op"),
          cls("cudaLaunchKernel", True, 160, 5, 9, "cuda_runtime"),
          cls("repro.mamba", True, 900, 50, 2, "user_annotation"),
          cls("cudaLaunchKernel", True, 910, 5, 10, "cuda_runtime"),
          cls("gemm", False, 400, 30, 7, "kernel"),
          cls("copy", False, 450, 30, 8, "kernel"),
          cls("add", False, 480, 30, 9, "kernel"),
          cls("late", False, 960, 30, 10, "kernel"),
          cls("repro.mamba", False, 100, 500, 7, "gpu_user_annotation")]
    assert read.mixer_device_ns(ev, 0, 500) == (30, 1)
    assert read.mixer_device_ns(ev, 0, 1000) == (60, 2)


def test_hybrid_flops_equal_the_audit():
    """The hybrid model FLOPs are the program's exact forward counted by
    ``FlopCounterMode``, less what its expert products add over every
    capacity slot."""
    from repro_torch.imc import model_analog as ma
    from repro_torch.launch.flops_audit import audit_step_flops
    from repro_torch.models import model as TM
    from repro_torch.models.ffn import moe_capacity

    cfg = smoke_archs()["granite-4.0-h-small-1period"]
    conf = smoke_cell().config
    B, S = 4, 64
    tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    got = audit_step_flops(lambda p, t: ma.model_forward_logits(p, cfg, t),
                           TM.abstract_params(cfg), tokens)
    # the program runs its three expert products over every capacity slot
    # (E x groups x capacity rows a layer, empty ones included), where the
    # model count takes each token's top k
    n = B * S
    tg = min(1024, n)
    slots = cfg.moe.num_experts * (n // tg) * moe_capacity(
        tg, cfg.moe.top_k, cfg.moe.num_experts)
    extra = 6 * cfg.d_model * cfg.moe.d_expert * cfg.n_layers * (
        slots - cfg.moe.top_k * n)
    assert got == hybrid_flops.forward_flops(conf, B, S) + extra


def test_analog_shapes_cover_every_routed_linear():
    conf = Cell(HYBRID).config
    assert sum(c for _, _, c in hybrid_flops.analog_shapes(conf)) == 35
    assert sum(c for _, _, c in hybrid_flops.analog_shapes(conf)) == len(
        hybrid.sites(hybrid.Arch(conf)))


def _shapes(tree, path=""):
    if torch.is_tensor(tree):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("size", ["smoke", "published"])
def test_weights_are_the_program_tree(size):
    from repro_torch.configs import registry
    from repro_torch.models import model as TM

    conf = Cell(HYBRID).config
    name = conf["program_arch"]
    if size == "smoke":
        cfg = smoke_archs()[name]
        conf = hybrid_conf(conf, cfg)
    else:
        cfg = registry.get_arch(name)
    want = _shapes(TM.abstract_params(cfg))
    got = {"/" + p: shape for p, (shape, _) in
           hybrid_weights.leaf_specs(conf).items()}
    assert got == want


def test_program_arch_refuses_another_model(program):
    c = smoke_cell()
    drv = c.driver()
    run = harness.Run(c, 1, 0.0, False, CPU, 0.0)
    assert drv.program_arch(run).name.startswith("granite-4.0-h-small")
    c.config = dict(c.config, residual_multiplier=1.0)
    with pytest.raises(ValueError, match="not the configuration"):
        drv.program_arch(harness.Run(c, 1, 0.0, False, CPU, 0.0))
