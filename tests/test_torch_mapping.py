"""The port's closed-form decode mapping (``imc.mapping.map_all``) against
the reference's over all ten archs, both device kinds: every field of
every ``ArchMapResult`` equal to rtol 1e-6 (both sides compute the
hierarchy's circuit models in float32; measured equal).  Both sides use the
reference's device write characterization (``test_torch_system.py``'s
fixture), so the CPU runs no 40,000-step eager write."""
import dataclasses

import numpy as np
import pytest

from repro.configs.registry import ARCHS as J_ARCHS
from repro.imc import hierarchy as jhier, mapping as jmap
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.imc import hierarchy as thier, mapping as tmap
from test_torch_system import shared_write_characterization  # noqa: F401

RTOL = 1e-6


def _close(got, want):
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, str):
            assert x == y, f.name
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, err_msg=f.name)
    np.testing.assert_allclose(got.speedup, want.speedup, rtol=RTOL)
    np.testing.assert_allclose(got.energy_saving, want.energy_saving,
                               rtol=RTOL)


def test_constants_match_reference():
    for name in ("XBAR", "IMC_PARALLEL_ARRAYS", "ADC_E_PER_COL", "ADC_T",
                 "CELLS_PER_WEIGHT_8B"):
        assert getattr(tmap, name) == getattr(jmap, name), name


def test_map_all_matches_reference(shared_write_characterization):  # noqa: F811
    got = tmap.map_all(T_ARCHS, device="cpu")
    want = jmap.map_all(J_ARCHS)
    assert set(got) == set(want) == {"afmtj", "mtj"}
    for kind in want:
        assert list(got[kind]) == list(want[kind])
        for name in want[kind]:
            _close(got[kind][name], want[kind][name])
    for name in want["afmtj"]:
        assert got["afmtj"][name].speedup > got["mtj"][name].speedup


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_map_arch_decode_matches_reference(kind,
                                           shared_write_characterization):  # noqa: F811
    hier_t = thier.build_hierarchy(kind, device="cpu")
    hier_j = jhier.build_hierarchy(kind)
    for name in ("qwen2-0.5b", "olmoe-1b-7b", "jamba-1.5-large-398b"):
        _close(tmap.map_arch_decode(T_ARCHS[name], hier_t),
               jmap.map_arch_decode(J_ARCHS[name], hier_j))


def test_map_all_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmap.map_all(T_ARCHS)
