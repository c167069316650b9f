"""The analog ``devices=`` split on the CPU (``imc.analog_pipeline``,
``imc.mapping``): the batch rows zero-padded and split over a device list
that names the CPU several times, one bit-line MAC call per entry,
against the unsplit call and against the reference's
``analog_matmul(devices=1)``, ``mvm_accuracy`` and
``decode_projection_accuracy``.

Bounds: split against unsplit, the reference test's (rtol 1e-5, atol
1e-7; ``tests/test_analog_pipeline.py::test_sharded_mvm_matches_single_
device``); against the reference, the existing parity bounds of
``tests/test_torch_analog.py`` (outputs rtol 1e-5 / atol 1e-5 of the
largest, nmse rel 1e-4, cosine rel 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.imc import analog_pipeline as jap
from repro.imc import mapping as jmapping
from repro_torch.configs.registry import get_arch
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import mapping as tmapping

CPU = "cpu"


def _wx(k=200, n=150, m=7, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return w, x


@pytest.fixture
def launches(monkeypatch):
    calls = []
    kernel = tap.bitline_mac_kernel

    def counted(v, g, *a):
        calls.append(tuple(v.shape))
        return kernel(v, g, *a)

    monkeypatch.setattr(tap, "bitline_mac_kernel", counted)
    return calls


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_split_matches_unsplit(n, launches):
    """7 x 200 @ 200 x 150, adc 6: one launch per device (at most one per
    row), each on its share of the zero-padded rows."""
    w, x = _wx()
    arr = tap.program_weights(w, "afmtj", tap.AnalogConfig(adc_bits=6),
                              device=CPU)
    y1 = tap.analog_matmul(arr, torch.from_numpy(x))
    del launches[:]
    yn = tap.analog_matmul(arr, torch.from_numpy(x), devices=[CPU] * n)
    used = min(n, 7)
    per = -(-7 // used)
    assert launches == [(per, 200)] * used
    np.testing.assert_allclose(yn.numpy(), y1.numpy(), rtol=1e-5, atol=1e-7)


def test_split_matches_reference_one_device():
    """The port's 4-way split against the reference's ``devices=1``."""
    w, x = _wx(k=130, n=100, m=5, seed=7)
    cfg_j, cfg_t = jap.AnalogConfig(adc_bits=6), tap.AnalogConfig(adc_bits=6)
    aj = jap.program_weights(jnp.asarray(w), "afmtj", cfg_j)
    at = tap.program_weights(w, "afmtj", cfg_t, device=CPU)
    yj = np.asarray(jap.analog_matmul(aj, jnp.asarray(x), devices=1))
    yt = tap.analog_matmul(at, torch.from_numpy(x), devices=[CPU] * 4)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("mode", ["analog", "bnn"])
def test_mvm_accuracy_with_devices(mode, launches):
    """The report's fields split equal unsplit (bnn ignores ``devices``, as
    the reference's does) and match the reference's ``devices=1``."""
    w, x = _wx()
    cfg_t = tap.AnalogConfig(adc_bits=6)
    r1 = tap.mvm_accuracy(w, x, cfg=cfg_t, mode=mode, device=CPU)
    del launches[:]
    r3 = tap.mvm_accuracy(w, x, cfg=cfg_t, mode=mode, device=CPU,
                          devices=[CPU] * 3)
    assert len(launches) == (3 if mode == "analog" else 0)
    for f in ("mse", "nmse", "cosine", "max_abs_err"):
        assert getattr(r3, f) == pytest.approx(getattr(r1, f), rel=1e-5,
                                               abs=1e-7)
    rj = jap.mvm_accuracy(jnp.asarray(w), jnp.asarray(x),
                          cfg=jap.AnalogConfig(adc_bits=6), mode=mode,
                          devices=1)
    assert (r3.m, r3.k, r3.n, r3.mode) == (rj.m, rj.k, rj.n, rj.mode)
    assert r3.nmse == pytest.approx(rj.nmse, rel=1e-4)
    assert r3.cosine == pytest.approx(rj.cosine, rel=1e-6)


def test_decode_projection_accuracy_with_devices(monkeypatch, launches):
    """qwen2-0.5b's decode projection split 4 ways (batch 8) against
    unsplit, and on the reference's projection draws against the
    reference's ``devices=1``."""
    cfg = get_arch("qwen2-0.5b")
    kw = dict(cap_k=128, cap_n=64)
    r1 = tmapping.decode_projection_accuracy(cfg, device=CPU, **kw)
    del launches[:]
    r4 = tmapping.decode_projection_accuracy(cfg, device=CPU,
                                             devices=[CPU] * 4, **kw)
    assert len(launches) == 4
    for f in ("mse", "nmse", "cosine", "max_abs_err"):
        assert getattr(r4, f) == pytest.approx(getattr(r1, f), rel=1e-5,
                                               abs=1e-7)

    def draws(seed, k, n, batch):
        kw_, kx = jax.random.split(jax.random.PRNGKey(seed))
        w = jax.random.normal(kw_, (k, n), jnp.float32) / (k ** 0.5)
        x = jax.random.normal(kx, (batch, k), jnp.float32)
        return (torch.from_numpy(np.array(w)),
                torch.from_numpy(np.array(x)))

    monkeypatch.setattr(tmapping, "projection_draws", draws)
    rj = jmapping.decode_projection_accuracy(J_ARCHS["qwen2-0.5b"],
                                             devices=1, **kw)
    rt = tmapping.decode_projection_accuracy(cfg, device=CPU,
                                             devices=[CPU] * 4, **kw)
    assert (rt.m, rt.k, rt.n) == (rj.m, rj.k, rj.n)
    assert rt.nmse == pytest.approx(rj.nmse, rel=1e-4)
    assert rt.cosine == pytest.approx(rj.cosine, rel=1e-6)


def test_split_devices_caps_and_counts():
    assert tap.split_devices(3, [CPU] * 5) == [torch.device(CPU)] * 3
    assert tap.split_devices(7, [CPU, CPU]) == [torch.device(CPU)] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tap.split_devices(4, 2)
