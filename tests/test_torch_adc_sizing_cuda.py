"""The fake-analog operand sizing on the card (``csrc/adc_sizing.cu``).

* The kernel's aux plane equals the plain version's (whose full scale is
  Python's ``float(f"{y:.2g}")``) on every value of the CPU rounding test
  (``tests/_rounding_cases.py``) and for every product of qwen2-0.5b
  smoke forwards, among them one with hard faults and spare-column repair
  (the mean attenuation over live columns).
* Fake-mode logits on the card equal device-mode logits (ROADMAP C5) and
  the logits of the host-float preamble the kernel replaced
  (``tests/_host_preamble_oracle.py``), bit for bit; with faults, the
  latter.
* ``_fake_mvm_body`` at a qwen2-0.5b shape makes no host sync: it runs
  under ``torch.cuda.set_sync_debug_mode("error")``.

Needs a CUDA device and nvcc; skips without them:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_adc_sizing_cuda.py
"""
import math

import pytest
import torch

from _host_preamble_oracle import host_fake_operands
from _rounding_cases import rounding_cases
from repro_torch.circuit.bitline import BitlineParams
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.imc import analog_pipeline as ap
from repro_torch.imc import model_analog as ma
from repro_torch.imc.faults import REPAIR_SPARE, FaultSpec
from repro_torch.kernels import adc_sizing, ref

pytestmark = pytest.mark.cuda

F32 = torch.float32
# (adc bits, process corner, hard faults at 3e-2 with spare-column repair)
POINTS = {"tt_adc8": (8, "tt", False), "ss_adc4": (4, "ss", False),
          "faults_repair": (6, "tt", True)}
FAULT_FREE = ("ss_adc4", "tt_adc8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_aux_plane_equals_plain_on_the_rounding_values(dev):
    """fs_sigmas = y with unit statistics (k_rows 1) sizes the full scale
    of y: the aux plane equals the plain version's, whose full scale is
    Python's ``float(f"{y:.2g}")``, on every value of the CPU test."""
    cases = rounding_cases()
    one = torch.ones((), dtype=F32)
    att = torch.tensor([1.0, 0.97, 0.5], dtype=F32)
    cell = [torch.tensor(v, dtype=F32) for v in (1e-4, 4.4e-4, 0.9, 2e3)]
    on = dict(w_max=one.to(dev), x_max=(one * 3).to(dev),
              att_mean=(one * 0.75).to(dev), g_rms=one.to(dev),
              v_rms=one.to(dev))
    off = {k: v.cpu() for k, v in on.items()}
    att_d, cell_d = att.to(dev), [c.to(dev) for c in cell]
    bad = []
    for y in cases:
        kw = dict(k_rows=1, fs_sigmas=y, v_read=0.2, g_fs=4.4e-4,
                  decode=True, i_max=None)
        got = adc_sizing.adc_aux_kernel(att_d, att_d, cell_d, **on, **kw)
        want = ref.ref_adc_aux(att, att, cell, **off, **kw)
        if not torch.equal(got.cpu(), want):
            bad.append(y)
    assert not bad, bad[:10]


def _smoke(dev):
    cfg = smoke_config("qwen2-0.5b")
    params = ma.init_model_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=dev)
    return cfg, params, tokens


def _acfg(point):
    bits, corner, faults = POINTS[point]
    kw = dict(adc_bits=bits, tmr=5.0, seed=3)
    if faults:
        kw.update(faults=FaultSpec.at_rate(3e-2, seed=1), repair=REPAIR_SPARE)
    spec = ma._corner_spec(corner, kw["seed"])
    return ap.AnalogConfig(**kw) if spec is None else ap.AnalogConfig(
        **kw, variation=spec)


@pytest.mark.parametrize("point", sorted(POINTS))
def test_every_product_of_a_forward_sizes_as_plain(point, dev, monkeypatch):
    cfg, params, tokens = _smoke(dev)
    real = ma.adc_aux_kernel
    seen = []

    def checked(att_p, att_n, cell, **kw):
        aux = real(att_p, att_n, cell, **kw)
        host = {k: v.cpu() if torch.is_tensor(v) else v
                for k, v in kw.items()}
        plain = ref.ref_adc_aux(att_p.cpu(), att_n.cpu(),
                                [c.cpu() for c in cell], **host)
        seen.append(torch.equal(aux.cpu(), plain))
        return aux

    monkeypatch.setattr(ma, "adc_aux_kernel", checked)
    ma.analog_model_logits(params, cfg, tokens, _acfg(point), device=dev)
    assert len(seen) == 7 * cfg.n_layers + 1 and all(seen), seen


@pytest.mark.parametrize("point", FAULT_FREE)
def test_fake_logits_equal_device_and_host_preamble(point, dev, monkeypatch,
                                                    tmp_path):
    cfg, params, tokens = _smoke(dev)
    acfg = _acfg(point)
    fake = ma.analog_model_logits(params, cfg, tokens, acfg, device=dev)
    device = ma.analog_model_logits(params, cfg, tokens, acfg, mode="device",
                                    cache_dir=str(tmp_path), device=dev)
    monkeypatch.setattr(ma, "fake_operands", host_fake_operands)
    host = ma.analog_model_logits(params, cfg, tokens, acfg, device=dev)
    assert torch.equal(fake, device)
    assert torch.equal(fake, host)


def test_fake_logits_with_faults_equal_host_preamble(dev, monkeypatch):
    cfg, params, tokens = _smoke(dev)
    acfg = _acfg("faults_repair")
    fake = ma.analog_model_logits(params, cfg, tokens, acfg, device=dev)
    monkeypatch.setattr(ma, "fake_operands", host_fake_operands)
    host = ma.analog_model_logits(params, cfg, tokens, acfg, device=dev)
    assert torch.isfinite(fake).all()
    assert torch.equal(fake, host)


@pytest.mark.parametrize("point", FAULT_FREE)
def test_fake_body_makes_no_host_sync(point, dev):
    """One product at qwen2-0.5b's w_gate shape (896 -> 4,864, 128 rows),
    after a first call that builds and warms, under the sync debug mode."""
    arch = get_arch("qwen2-0.5b")
    k, n = arch.d_model, arch.d_ff
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(128, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    acfg = _acfg(point)
    setup = ma.fake_setup("afmtj", acfg, dev)
    bl = BitlineParams(rows=k)
    first = ma._fake_mvm_body(x, w, setup, bl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ma._fake_mvm_body(x, w, setup, bl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)
