"""The port's counter-RNG against the reference's: the uint32 stream is
bit-identical (hashes, per-lane seeds, per-slice seeds, uniforms), and the
Box-Muller normals agree to a few float32 ulp (log/cos/sin are different
libraries on the two sides: XLA's CPU kernels vs PyTorch's)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import noise as jnoise
from repro_torch.kernels import noise as tnoise

MASK = 0xFFFFFFFF
# measured: at most 3 ulp between the two sides' normals over 4096 lanes x
# 7 steps (incl. counters that wrap 2^32); 4 leaves one ulp of headroom
NORMAL_ULP = 4


def _u32(rng, n):
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    vals[:4] = [0, 1, MASK - 1, MASK]
    return vals.astype(np.uint32)


def test_mix32_bit_equal():
    x = _u32(np.random.default_rng(0), 10_000)
    ref = np.asarray(jnoise.mix32(jnp.asarray(x)))
    got = tnoise.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(ref.astype(np.int64), got)
    # the Python-int path (used for per-step counters) agrees too
    for v in x[:64]:
        assert tnoise.mix32(int(v)) == int(jnoise.mix32(jnp.uint32(v)))


@pytest.mark.parametrize("base", [0, 1, 42, 2**31 + 5, MASK, 2**40 + 7])
def test_cell_seeds_bit_equal(base):
    ref = np.asarray(jnoise.cell_seeds(base, 3000)).view(np.int32)
    got = tnoise.cell_seeds(base, 3000, device="cpu").numpy()
    assert got.dtype == np.int32
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("seed,slice_index", [(0, 0), (0, 2), (7, 1),
                                              (1009 * 3 + 2, 0), (MASK, 5)])
def test_slice_seeds_bit_equal(seed, slice_index):
    ref = np.asarray(jnoise.slice_seeds(seed, slice_index, 1536))
    got = tnoise.slice_seeds(seed, slice_index, 1536, device="cpu").numpy()
    assert np.array_equal(ref.view(np.int32), got)


@pytest.mark.parametrize("counter", [0, 1, 3 * 977, 2**31, MASK - 2, MASK])
def test_counter_hash_and_uniforms_bit_equal_near_wrap(counter):
    """``counter * GOLD`` overflows int64 for counters near 2^32; the low
    32 bits — the uint32 result — must survive the wraparound."""
    seeds = np.asarray(jnoise.cell_seeds(11, 512))
    ref_base = seeds ^ np.asarray(
        jnoise.mix32(jnp.uint32(counter) * jnoise._GOLD + jnp.uint32(1)))
    t_seeds = tnoise.as_uint32(torch.from_numpy(seeds.astype(np.int64)))
    got_base = t_seeds ^ tnoise.mix32(((counter * tnoise._GOLD) + 1) & MASK)
    got_base_t = t_seeds ^ tnoise.mix32(
        ((torch.tensor(counter, dtype=torch.int64) * tnoise._GOLD) + 1) & MASK)
    assert np.array_equal(ref_base.astype(np.int64), got_base.numpy())
    assert np.array_equal(ref_base.astype(np.int64), got_base_t.numpy())
    u_ref = np.asarray(jnoise._uniform24(jnoise.mix32(jnp.asarray(ref_base))))
    u_got = tnoise._uniform24(tnoise.mix32(got_base)).numpy()
    assert np.array_equal(u_ref, u_got)


def test_int32_bit_pattern_round_trip():
    x = torch.from_numpy(_u32(np.random.default_rng(1), 1000).astype(np.int64))
    bits = tnoise.as_int32_bits(x)
    assert bits.dtype == torch.int32
    assert torch.equal(tnoise.as_uint32(bits), x)


@pytest.mark.parametrize("step", [0, 1, 17, 1000, 1431655764, 1431655765,
                                  2**31 - 1])
def test_thermal_draws_within_ulp(step):
    seeds = jnoise.cell_seeds(123, 4096)
    ref = jnoise.thermal_draws(seeds, jnp.uint32(step))
    got = tnoise.thermal_draws(
        torch.from_numpy(np.asarray(seeds).astype(np.int64)), step)
    for a, b in zip(ref[0] + ref[1], got[0] + got[1]):
        a = np.asarray(a)
        b = b.numpy()
        scale = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        assert (np.abs(a - b) <= NORMAL_ULP * scale).all(), step
