"""The port's architecture registry against the reference's, for all ten
archs: the configs, their smoke reductions, parameter counts and training
microbatch counts are equal (plain data, compared exactly); building a
model whose blocks the port does not run raises ``NotImplementedError``."""
import dataclasses

import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.models import model as tmodel

NAMES = list(jreg.ARCHS)
# archs with blocks the port's model stack does not run (MoE, Mamba,
# encoder-decoder); the dense decoders build
UNPORTED = ("llama4-maverick-400b-a17b", "olmoe-1b-7b",
            "seamless-m4t-large-v2", "mamba2-780m", "jamba-1.5-large-398b")


def test_registry_holds_the_ten_archs_in_order():
    assert len(NAMES) == 10
    assert list(treg.ARCHS) == NAMES
    assert treg.TRAIN_MICROBATCHES == jreg.TRAIN_MICROBATCHES


@pytest.mark.parametrize("name", NAMES)
def test_arch_matches_reference(name):
    t, j = treg.get_arch(name), jreg.get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    ts, js = treg.smoke_config(name), jreg.smoke_config(name)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.param_count() == js.param_count()
    assert ts.active_param_count() == js.active_param_count()


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_blocks_raise(name):
    with pytest.raises(NotImplementedError, match="A9b"):
        tmodel.init_params(treg.smoke_config(name),
                           torch.Generator().manual_seed(0), "cpu")


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("no-such-arch")
