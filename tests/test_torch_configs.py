"""The port's architecture registry against the reference's, for all ten
archs: the configs, their smoke reductions, parameter counts and training
microbatch counts are equal (plain data, compared exactly).  Every arch's
model builds (``tests/test_torch_model_families.py``)."""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

NAMES = list(jreg.ARCHS)


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


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("no-such-arch")
