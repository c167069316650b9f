"""The analog GEMMs' split-K rule, a plain function, checked on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``, where the
split shapes also check that the chunks cover K: the XNOR GEMM is exact).
What is held here is the rule itself: one wave at most, the split 1 when
the output tiles already fill the SMs, never more chunks than BK steps (the
kernels' chunks are whole steps, ``k_range`` in ``csrc/split_k.cuh``, so
none is then empty), and one float32 (M, N) workspace plane per chunk.
The fake-analog MVM (B5, ``csrc/fake_analog.cu``) takes its split count
from the bit-line MAC's tile whatever its own tile, so the two add the same
products in the same order.  The wrappers' CPU path against the JAX
reference is in ``tests/test_torch_analog.py``.
"""
import pytest
import torch

from repro_torch.kernels import analog_mac, fake_analog
from repro_torch.kernels.analog_mac import split_count, workspace

H100_SMS = 132
QWEN_M = 128
# qwen2-0.5b's linears at batch 2 x seq 64: (K, N) -> splits on 132 SMs
QWEN_SPLITS = {
    "mac": {(896, 896): 18, (896, 128): 56, (896, 4864): 3, (4864, 896): 18,
            (896, 151936): 1},
    "xnor": {(896, 896): 28, (896, 128): 28, (896, 4864): 6, (4864, 896): 33,
             (896, 151936): 1},
}
# (BM, BN, BK) of csrc/analog_mac.cu and csrc/xnor_gemm.cu (the wrappers
# read them from the built libraries; the rule takes any tile)
TILES = {"mac": (128, 128, 16), "xnor": (128, 256, 32)}
EDGE_SHAPES = [(3, 200, 77), (65, 130, 190), (1, 1, 1), (129, 127, 128),
               (1, 20, 77), (2, 100, 190), (1, 600, 96)]


def _tiles(m, n, tile):
    return -(-m // tile[0]) * -(-n // tile[1])


@pytest.mark.parametrize("kernel", ["mac", "xnor"])
@pytest.mark.parametrize("kn", list(QWEN_SPLITS["mac"]))
def test_split_count_at_the_model_shapes(kernel, kn):
    k, n = kn
    tile = TILES[kernel]
    s = split_count(QWEN_M, n, k, tile, H100_SMS)
    assert s == QWEN_SPLITS[kernel][kn]
    # one wave at most, and 1 exactly when the tiles fill the SMs
    assert s * _tiles(QWEN_M, n, tile) <= max(H100_SMS,
                                              _tiles(QWEN_M, n, tile))
    assert (s == 1) == (_tiles(QWEN_M, n, tile) * 2 > H100_SMS)


@pytest.mark.parametrize("kernel", ["mac", "xnor"])
@pytest.mark.parametrize("m,k,n", EDGE_SHAPES + [
    (QWEN_M, k, n) for k, n in QWEN_SPLITS["mac"]])
def test_no_chunk_without_a_k_step(kernel, m, k, n):
    bk = TILES[kernel][2]
    s = split_count(m, n, k, TILES[kernel], H100_SMS)
    assert 1 <= s <= -(-k // bk)
    assert s * _tiles(m, n, TILES[kernel]) <= max(H100_SMS,
                                                  _tiles(m, n, TILES[kernel]))


@pytest.mark.parametrize("kernel", ["mac", "xnor"])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 20, 33, 47, 64, 100])
def test_small_k_is_never_over_split(kernel, k):
    """K smaller than the unclamped split x BK: the split shrinks to whole
    steps (a single tile would otherwise ask for 132 chunks)."""
    bk = TILES[kernel][2]
    assert H100_SMS * bk > k
    s = split_count(1, 77, k, TILES[kernel], H100_SMS)
    assert 1 <= s <= -(-k // bk)


@pytest.mark.parametrize("kernel", ["mac", "xnor"])
@pytest.mark.parametrize("n_sm", [1, 16, 132, 1000])
def test_split_is_one_when_the_tiles_fill_the_sms(kernel, n_sm):
    tile = TILES[kernel]
    n = tile[1] * n_sm                       # exactly one tile per SM
    assert split_count(QWEN_M, n, 4864, tile, n_sm) == 1
    assert split_count(QWEN_M, 2 * n, 4864, tile, n_sm) == 1


@pytest.mark.parametrize("splits,m,n", [(1, 128, 151936), (18, 128, 896),
                                        (3, 1, 77)])
def test_workspace_holds_one_plane_per_chunk(splits, m, n):
    ws = workspace(splits, m, n, "cpu")
    if splits == 1:
        assert ws is None
    else:
        assert ws.shape == (splits, m, n) and ws.dtype == torch.float32
    assert analog_mac.ptr(ws) == (None if ws is None else ws.data_ptr())


@pytest.mark.parametrize("fake_tile", [(128, 128, 16), (128, 64, 16),
                                       (64, 128, 16), (128, 256, 16)])
@pytest.mark.parametrize("m,k,n", EDGE_SHAPES + [
    (QWEN_M, k, n) for k, n in QWEN_SPLITS["mac"]])
def test_fake_analog_splits_as_the_bitline_mac(monkeypatch, fake_tile, m, k,
                                               n):
    """B5's launch plan (the wrapper's ``plan`` call) splits K as B3's tile
    does, whatever B5's own tile: the same chunks at every shape."""
    tiles = {"analog_mac": TILES["mac"], "fake_analog": fake_tile}
    monkeypatch.setattr(analog_mac, "library", lambda name: name)
    monkeypatch.setattr(analog_mac, "tile", tiles.__getitem__)
    monkeypatch.setattr(analog_mac, "sm_count", lambda index: H100_SMS)
    like = torch.empty(1)
    lib, s, ws = analog_mac.plan("fake_analog", m, k, n, like,
                                 split_tile=fake_analog.SPLIT_TILE)
    assert lib == "fake_analog"
    assert s == split_count(m, n, k, TILES["mac"], H100_SMS)
    if m == QWEN_M and (k, n) in QWEN_SPLITS["mac"]:
        assert s == QWEN_SPLITS["mac"][(k, n)]
    assert (ws is None) == (s == 1)
