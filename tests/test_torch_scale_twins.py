"""The twins of this slice on the CPU against the reference, at cut sizes:
``examples/torch_array_mc_sim.py`` on the reference's ``jax.random`` tilts
against the reference's ``run_ensemble`` (``backend="ref"``),
``examples/torch_analog_accuracy.py`` on the reference's projection draws
against ``mapping.accuracy_surface``, and section 4 of
``examples/torch_fault_study.py`` (crash and resume).

Bounds: crossing steps as ``test_torch_campaign.py`` (C3: at most 2 steps
apart on at most 1% of lanes), the margined pulse equal on shared campaign
tilts; nmse rtol 1e-5 and cosine rtol 1e-6 (C12, as
``test_torch_write_surface.py``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import run_ensemble as jrun_ensemble
from repro.configs.registry import ARCHS as J_ARCHS
from repro.core import llg as jllg
from repro.core.device import thermal_theta0 as jtheta0
from repro.core.params import AFMTJ_PARAMS as J_AFMTJ
from repro.core.params import VariationSpec as JVariationSpec
from repro.imc import mapping as jmapping
from repro.imc.write_margin import wer_margined_pulse as jwer_margined_pulse
from test_torch_campaign import (ROW7_FRAC, ROW7_STEPS,  # noqa: F401
                                 shared_tilts)

ROOT = Path(__file__).resolve().parents[1]


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_tilts(n: int):
    """The reference example's draws (``examples/array_mc_sim.py:31-36``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    th0 = float(jtheta0(J_AFMTJ))
    theta = jnp.abs(jax.random.normal(k1, (n,))) * th0 + 0.02
    phi = jax.random.uniform(k2, (n,), maxval=2 * jnp.pi)
    return theta, phi


@pytest.mark.parametrize("shape,n_steps", [((16, 16), 1300),
                                           ((8, 64), 1500)])
def test_array_mc_twin_matches_reference(shape, n_steps, shared_tilts):
    twin = _twin("torch_array_mc_sim")
    rows, cols = shape
    n = rows * cols
    theta, phi = _ref_tilts(n)
    got = twin.run("cpu", rows=rows, cols=cols, n_steps=n_steps,
                   theta=np.asarray(theta), phi=np.asarray(phi),
                   use_cache=False)
    m0 = jax.vmap(lambda t, f: jllg.initial_state(J_AFMTJ, t, f))(theta, phi)
    v = 1.0 - 0.15 * ((jnp.arange(n) // cols) / rows)
    ref = jrun_ensemble(J_AFMTJ, m0, v, twin.DT, n_steps, seed=0,
                        backend="ref")
    d = np.abs(got["crossing_steps"] - np.asarray(ref.crossing_steps))
    assert (d > 0.5).mean() <= ROW7_FRAC and d.max() <= ROW7_STEPS + 1e-6
    sw = np.asarray(ref.switched)
    assert got["switched"] == pytest.approx(sw.mean(), abs=ROW7_FRAC)
    assert got["v_worst"] == float(jnp.min(v))
    ok = np.asarray(ref.crossing_time)[sw]
    assert got["p50"] == pytest.approx(np.percentile(ok, 50),
                                       abs=ROW7_STEPS * twin.DT)
    assert got["pulse"] == jwer_margined_pulse(
        "afmtj", v_write=round(got["v_worst"], 2), wer_target=1e-2,
        use_cache=False)
    lines = twin.report(got)
    assert lines[0].startswith(f"array {rows}x{cols} @300K:")
    assert "controller pulse" in lines[-1]


def _ref_draws(seed, k, n, batch):
    kw, kx = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(kw, (k, n), jnp.float32) / (k ** 0.5)
    x = jax.random.normal(kx, (batch, k), jnp.float32)
    return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m"])
def test_analog_accuracy_twin_matches_reference(arch):
    twin = _twin("torch_analog_accuracy")
    caps = dict(cap_k=128, cap_n=64, batch=4)
    got = twin.run("cpu", archs=(arch,), caps=caps, draws=_ref_draws)[arch]
    cfg = J_ARCHS[arch]
    var = JVariationSpec.from_g_sigma(twin.G_SIGMA)
    surf = jmapping.accuracy_surface(cfg, kind="afmtj",
                                     adc_bits=twin.ADC_BITS, tmrs=twin.TMRS,
                                     variation=var, **caps)
    bnn = jmapping.decode_projection_accuracy(cfg, kind="afmtj", mode="bnn",
                                              **caps)
    want = {f"{b}/{t}": (r.mse, r.nmse, r.cosine)
            for (b, t), r in sorted(surf.items())}
    assert list(got["surface"]) == list(want)
    for key, (mse, nmse, cos) in want.items():
        g = got["surface"][key]
        np.testing.assert_allclose(g[1], nmse, rtol=1e-5)
        np.testing.assert_allclose(g[2], cos, rtol=1e-6)
    np.testing.assert_allclose(got["bnn"][1], bnn.nmse, rtol=1e-5)
    np.testing.assert_allclose(got["bnn"][2], bnn.cosine, rtol=1e-6)
    assert got["shape"] == (4,) + jmapping.decode_projection_shapes(
        cfg, 128, 64)
    assert any("bnn(1b)" in line for line in twin.report({arch: got}))


def test_fault_study_section_4_resumes_bit_identical():
    twin = _twin("torch_fault_study")
    rs = twin.resume_demo("cpu")
    assert rs == dict(crashed=[(0, 2)], n_launches=2, n_resumed=1, same=True)
    lines = twin.report(dict(
        yields=[], arch="x", batch=1, seq_len=1, rates=[], curves={},
        knees={}, bar=0.0, n_requests=0, slo=[], resume=rs))
    i = lines.index("== crash-resumable campaign ==")
    assert lines[i + 1] == "  launch 1/2 checkpointed ... simulated crash"
    assert lines[i + 2] == ("  resumed: 1/2 launches from checkpoints, "
                            "crossing tensor bit-identical=True")
