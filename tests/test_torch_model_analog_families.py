"""The model-level analog path on the MoE, Mamba and hybrid archs
(olmoe-1b-7b, mamba2-780m, jamba-1.5-large-398b smoke configs, batch 2 x
seq 64: 128 tokens, so the MoE drops over capacity as at full width)
against the JAX reference on the CPU, on the reference's parameters.

Bounds:

* exact logits: atol 1e-4 (ROADMAP C6), except jamba: 1e-3 — its smoke
  model carries Mamba states of ~1e4 through 4 MoE layers, and the
  reference's own float32 logits sit up to 4.3e-4 from a float64
  evaluation of the same model (measured port vs reference: 2.1e-4);
* fake, device and bnn logits against the reference's same mode: KL < 1e-4
  and token match 1.0 (measured KL <= 5.7e-6).
"""
import jax
import numpy as np
import pytest
import torch

from repro.imc import analog_pipeline as jap
from repro.imc import model_analog as jma
from repro_torch.imc import analog_pipeline as tap
from repro_torch.imc import model_analog as tma
from repro_torch.models import model as TM

BATCH, SEQ = 2, 64
LOGIT_ATOL = {"jamba-1.5-large-398b": 1e-3}
ANALOG_ARCHS = ["olmoe-1b-7b", "mamba2-780m", "jamba-1.5-large-398b"]


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def analog_states():
    """Per arch: the reference's (cfg, params, tokens, exact logits) and the
    port's from the same parameters."""
    out = {}
    mp = pytest.MonkeyPatch()
    for arch in ANALOG_ARCHS:
        js = jma._setup(arch, True, BATCH, SEQ, 0)
        tree = jax.tree_util.tree_map(np.asarray, js[1])
        mp.setattr(tma, "init_model_params",
                   lambda cfg, seed, device, _t=tree:
                   TM.params_from_reference(_t, device))
        out[arch] = (js, tma._setup(arch, True, BATCH, SEQ, 0, "cpu"))
    mp.undo()
    return out


@pytest.mark.parametrize("arch", ANALOG_ARCHS)
def test_exact_logits_match_reference(arch, analog_states):
    js, ts = analog_states[arch]
    assert np.array_equal(_np(ts[2]), np.asarray(js[2]))
    d = np.abs(_np(ts[3]) - np.asarray(js[3])).max()
    assert d <= LOGIT_ATOL.get(arch, 1e-4), d


@pytest.mark.parametrize("mode", ["fake", "device", "bnn"])
@pytest.mark.parametrize("arch", ANALOG_ARCHS)
def test_analog_modes_match_reference(arch, mode, analog_states, tmp_path):
    (jcfg, jparams, jtokens, _), (cfg, params, tokens, _) = \
        analog_states[arch]
    yj = jma.analog_model_logits(jparams, jcfg, jtokens,
                                 jap.AnalogConfig(adc_bits=8, tmr=5.0),
                                 mode=mode, cache_dir=str(tmp_path / "j"))
    yt = tma.analog_model_logits(params, cfg, tokens,
                                 tap.AnalogConfig(adc_bits=8, tmr=5.0),
                                 mode=mode, cache_dir=str(tmp_path / "t"),
                                 device="cpu")
    assert yt.shape == (BATCH, SEQ, cfg.vocab) and torch.isfinite(yt).all()
    kl, match, _, _ = tma.logit_metrics(np.asarray(yj), yt, tokens)
    assert abs(kl) < 1e-4 and match == 1.0, (kl, match)
