"""The LLG kernel's layout rule and the wrapper's ``layout=`` argument, on
the CPU.

A launch maps each 512-lane exit group onto C blocks (C a power of two up
to 16; a thread-block cluster when the chunked exit votes across them)
with T threads per lane (T = 2 only for the two-sublattice AFMTJ) and P
noise producers (P = 1 only for chunked thermal launches whose chunk is
a multiple of the producers' batch, with C >= 8).  The rule, a plain
function, is pinned here at the H100's 132 SMs, at the launch shapes
timed on that card (chip_smoke.py phase 4) and at its edges.  The kernel runs only on the card
(``tests/test_torch_cuda.py`` holds every layout bit-identical to the
plain version there); on the CPU the wrapper checks ``layout`` and runs
the plain version, which has no layout.
"""
import math

import pytest
import torch

from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS
from repro_torch.kernels import noise
from repro_torch.kernels.llg_rk4 import (CLUSTER_SIZES, PRODUCER_BATCH,
                                         PRODUCER_MIN_C, SPREAD_MAX_GROUPS,
                                         check_layout, layout_rule,
                                         llg_rk4_kernel, takes_producers)
from repro_torch.kernels.ref import CELL_TILE

H100_SMS = 132
# the main path's launch shapes (lanes, sublattices) -> layout on 132 SMs
# (all chunked thermal launches, chunk 64)
MAIN_PATH = {
    "campaign afmtj": (786_432, 2, (1, 1, 0)),
    "write-verify afmtj 4096": (4096, 2, (16, 2, 1)),
    "write-verify afmtj 8192": (8192, 2, (16, 2, 1)),
    "write-verify mtj 4096": (4096, 1, (16, 1, 1)),
    "write-verify mtj 8192": (8192, 1, (16, 1, 1)),
    "WER ladder afmtj": (512, 2, (16, 2, 1)),
    "WER ladder mtj": (512, 1, (16, 1, 1)),
}
# write-verify rounds of 32, 64 and 128 groups (chip_smoke.py phase 4b)
RULE_RANGE = {
    "afmtj 32 groups": (32 * CELL_TILE, 2, (8, 2, 1), (8, 2, 0)),
    "afmtj 64 groups": (64 * CELL_TILE, 2, (8, 2, 1), (4, 2, 0)),
    "afmtj 128 groups": (128 * CELL_TILE, 2, (1, 1, 0), (1, 1, 0)),
    "mtj 32 groups": (32 * CELL_TILE, 1, (8, 1, 1), (8, 1, 0)),
    "mtj 64 groups": (64 * CELL_TILE, 1, (8, 1, 1), (4, 1, 0)),
    "mtj 128 groups": (128 * CELL_TILE, 1, (1, 1, 0), (1, 1, 0)),
}
EDGE_GROUPS = [1, 2, 3, 7, 8, 9, 16, 17, 33, 65, 66, 67, 131, 132, 133, 1536]


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_rule_at_the_main_path_shapes(name):
    cells, nsub, want = MAIN_PATH[name]
    assert takes_producers(True, 64)
    assert layout_rule(cells, nsub, H100_SMS) == want
    # a launch that cannot take producers gets the same C and T
    assert layout_rule(cells, nsub, H100_SMS, False) == (*want[:2], 0)


@pytest.mark.parametrize("name", list(RULE_RANGE))
def test_rule_between_the_main_path_and_a_full_card(name):
    cells, nsub, want, no_prod = RULE_RANGE[name]
    assert layout_rule(cells, nsub, H100_SMS) == want
    assert layout_rule(cells, nsub, H100_SMS, False) == no_prod


@pytest.mark.parametrize("groups", EDGE_GROUPS)
@pytest.mark.parametrize("nsub", [1, 2])
@pytest.mark.parametrize("producers", [True, False])
def test_rule_edges(groups, nsub, producers):
    c, t, prod = layout_rule(groups * CELL_TILE, nsub, H100_SMS, producers)
    assert c in CLUSTER_SIZES and c & (c - 1) == 0 and c <= 16
    assert (CELL_TILE // c) % 32 == 0      # each block holds whole warps
    assert t in (1, 2)
    assert nsub == 2 or t == 1             # NSUB = 1 never splits a lane
    if groups >= H100_SMS or groups > SPREAD_MAX_GROUPS:
        assert (c, t, prod) == (1, 1, 0)   # full card, or beyond the range
    else:                                  # the least C that fills it
        assert prod == int(producers)
        assert groups * c >= H100_SMS or c == 16
        assert (c == 1 or groups * (c // 2) < H100_SMS
                or (producers and c == PRODUCER_MIN_C))
    assert check_layout((c, t, prod), nsub) == (c, t, prod)   # valid


def test_rule_one_group_and_a_full_card():
    assert layout_rule(CELL_TILE, 2, H100_SMS) == (16, 2, 1)
    assert layout_rule(CELL_TILE, 1, H100_SMS) == (16, 1, 1)
    assert layout_rule(CELL_TILE, 1, H100_SMS, False) == (16, 1, 0)
    assert layout_rule(2 * CELL_TILE, 1, H100_SMS) == (16, 1, 1)
    assert layout_rule(H100_SMS * CELL_TILE, 2, H100_SMS) == (1, 1, 0)
    assert layout_rule(H100_SMS * CELL_TILE, 1, H100_SMS) == (1, 1, 0)
    # a ragged lane count rounds up to whole groups; producers raise C to 8
    assert layout_rule(CELL_TILE + 1, 1, 4, False) == (2, 1, 0)
    assert layout_rule(CELL_TILE + 1, 1, 4) == (8, 1, 1)


@pytest.mark.parametrize("thermal,chunk,want", [
    (True, 64, True), (True, PRODUCER_BATCH, True), (True, 0, False),
    (True, 12, False), (True, -1, False), (False, 64, False)])
def test_takes_producers(thermal, chunk, want):
    assert takes_producers(thermal, chunk) == want


@pytest.mark.parametrize("layout,nsub", [
    ((3, 1), 2), ((32, 1), 2), ((0, 1), 1), ((-2, 1), 2), ((1, 3), 2),
    ((1, 0), 2), ((2, 2), 1), ((1, 2), 1), ((2.0, 1), 2), ((True, 1), 2),
    ((2,), 2), ((2, 1, 1), 2), ((4, 2, 1), 2), ((16, 1, 2), 1),
    ((16, 2, 1), 1), ((8, 1, -1), 2), ((16, 1, 1, 0), 1), ("c2t1", 2),
    (2, 2)])
def test_check_layout_rejects(layout, nsub):
    with pytest.raises(ValueError):
        check_layout(layout, nsub)


@pytest.mark.parametrize("nsub", [1, 2])
def test_check_layout_accepts_every_valid_layout(nsub):
    valid = [(c, t, p) for c in CLUSTER_SIZES for t in (1, 2) for p in (0, 1)
             if (t == 1 or nsub == 2) and (p == 0 or c >= PRODUCER_MIN_C)]
    assert len(valid) == (7 if nsub == 1 else 14)
    for c, t, p in valid:
        assert check_layout((c, t, p), nsub) == (c, t, p)
        assert check_layout([c, t, p], nsub) == (c, t, p)
        if p == 0:
            assert check_layout((c, t), nsub) == (c, t, 0)


def _state(p, cells):
    gen = torch.Generator().manual_seed(11)
    th = torch.rand(cells, generator=gen) * 0.3 + 0.05
    ph = torch.rand(cells, generator=gen) * 2 * math.pi
    s = torch.zeros(8, cells)
    s[0:3] = torch.stack([th.sin() * ph.cos(), th.sin() * ph.sin(),
                          th.cos()])
    if p.n_sublattices == 2:
        s[3:6] = -s[0:3]
    s[6] = torch.linspace(0.6, 2.0, cells)
    return s


@pytest.mark.parametrize("kind", ["afmtj", "mtj"])
def test_cpu_path_ignores_a_valid_layout(kind):
    p = AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS
    cells, n = CELL_TILE, 40
    st = _state(p, cells)
    kw = dict(thermal_sigma=0.01, seeds=noise.cell_seeds(4, cells, "cpu"),
              chunk=16)
    before = llg_rk4_kernel.launches
    plain = llg_rk4_kernel(st, p, 1e-13, n, **kw)
    t = 2 if kind == "afmtj" else 1
    for layout in [(1, 1), (16, t), (4, t), (16, t, 1), (8, t, 1)]:
        assert torch.equal(llg_rk4_kernel(st, p, 1e-13, n, **kw,
                                          layout=layout), plain)
    assert llg_rk4_kernel.launches == before      # plain calls do not count


@pytest.mark.parametrize("layout", [(3, 1), (1, 2), (32, 1), (2.0, 1),
                                    (4, 1, 1), (16, 1, 1)])
def test_wrapper_rejects_a_bad_layout(layout):
    # (1, 2) splits a lane over two threads, which the MTJ cannot take;
    # (16, 1, 1) asks for noise producers in a deterministic launch
    st = _state(MTJ_PARAMS, CELL_TILE)
    before = llg_rk4_kernel.launches
    with pytest.raises(ValueError):
        llg_rk4_kernel(st, MTJ_PARAMS, 2e-13, 10, layout=layout)
    assert llg_rk4_kernel.launches == before


@pytest.mark.parametrize("chunk", [0, 12])
def test_wrapper_rejects_producers_without_whole_batches(chunk):
    st = _state(MTJ_PARAMS, CELL_TILE)
    kw = dict(thermal_sigma=0.01, seeds=noise.cell_seeds(4, CELL_TILE, "cpu"),
              chunk=chunk)
    llg_rk4_kernel(st, MTJ_PARAMS, 2e-13, 24, **kw, layout=(16, 1, 0))
    with pytest.raises(ValueError):
        llg_rk4_kernel(st, MTJ_PARAMS, 2e-13, 24, **kw, layout=(16, 1, 1))
