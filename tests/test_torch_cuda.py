"""The CUDA LLG kernel against its plain PyTorch version, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc; without them they skip.  On a machine with both:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Bound: the reference's kernel-vs-oracle bound, rows 0-5 within atol 2e-5
and row 7 equal (the kernel follows the plain version operation by
operation, so both are usually bit-identical).
"""
import math

import pytest
import torch

from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.kernels import noise, ref
from repro_torch.kernels.llg_rk4 import llg_rk4_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _states(p, cells, vlo, vhi, dev):
    gen = torch.Generator().manual_seed(5)
    th = torch.rand(cells, generator=gen) * 0.35 + 0.05
    ph = torch.rand(cells, generator=gen) * 2 * math.pi
    m1 = torch.stack([th.sin() * ph.cos(), th.sin() * ph.sin(), th.cos()])
    s = torch.zeros(8, cells)
    s[0:3] = m1
    if p.n_sublattices == 2:
        s[3:6] = -m1
    s[6] = torch.linspace(vlo, vhi, cells)
    return s.to(dev)


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
@pytest.mark.parametrize("case", ["det", "chunk0", "chunk64", "variation"])
def test_kernel_matches_plain_version(dev, kind, case):
    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    dt, n, v = ((0.1e-12, 800, (0.6, 2.0)) if kind == "afmtj"
                else (0.2e-12, 1500, (2.0, 5.0)))
    cells = 1024
    st = _states(p, cells, *v, dev)
    kw = {}
    if case != "det":
        lane = torch.arange(cells, device=dev)
        budget = torch.where(lane % 5 == 0, float(n // 3), float(n))
        kw = dict(thermal_sigma=thermal_sigma(p, dt), seeds=noise.cell_seeds(
            3, cells, dev), step_budget=budget.float(),
            chunk=0 if case == "chunk0" else 64)
        if case == "variation":
            kw["lane_params"] = torch.stack([
                torch.full((cells,), p.alpha, device=dev) * 1.1,
                torch.full((cells,), p.b_aniso, device=dev) * 0.95,
                torch.full((cells,), 1.05, device=dev)])
    before = llg_rk4_kernel.launches
    out = llg_rk4_kernel(st, p, dt, n, **kw)
    torch.cuda.synchronize()
    assert llg_rk4_kernel.launches == before + 1
    plain = ref.ref_llg_rk4(st, p, dt, n, **kw)
    torch.testing.assert_close(out[:6], plain[:6], rtol=0, atol=2e-5)
    assert torch.equal(out[6:], plain[6:])


def test_kernel_rejects_bad_shapes(dev):
    st = torch.zeros(8, 500, device=dev)
    with pytest.raises(ValueError):
        llg_rk4_kernel(st, AFMTJ_PARAMS, 1e-13, 10)
