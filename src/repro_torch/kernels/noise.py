"""Counter-based Gaussian noise shared by the CUDA kernel and its plain
version — port of ``repro.kernels.noise``, the same uint32 stream bit for
bit.

Every draw is ``mix(cell_seed ^ mix(counter * GOLD + 1))`` where ``mix`` is
the lowbias32 full-avalanche hash and the counter encodes (step, draw
index); Box-Muller turns two hashes into two normals.  Stateless: the noise
at step ``i`` is a pure function of (seed, i), so the kernel, this module
and the reference all consume the identical stream.

uint32 arithmetic here runs on int64 tensors (and Python ints) holding
values in [0, 2^32), masked with ``& 0xFFFFFFFF`` after every product:
PyTorch's uint32 support is partial.  Products of two values below 2^32
can exceed 2^63 (``counter * _GOLD`` near counter 2^32); int64
multiplication then wraps in two's complement, which leaves the low 32
bits — all that uint32 arithmetic keeps — exact.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLD = 0x9E3779B9       # 2^32 / phi — Weyl counter increment
_M1 = 0x21F0AAAD         # lowbias32 (Degski / TheIronBorn) v2
_M2 = 0x735A2D97
_TWO_PI = 6.283185307179586
_INV_2_24 = float(2.0**-24)

_SLICE_GOLD = 0x9E3779B1        # odd Weyl constants: campaign seed ...
_SLICE_OFF = 0x85EB_CA6B        # ... and per-temperature-slice offset


def mix32(x):
    """lowbias32 on uint32 values held in an int64 tensor or a Python int."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & _MASK
    x = x ^ (x >> 15)
    return x


def as_uint32(seeds: torch.Tensor) -> torch.Tensor:
    """Seeds held as int32 bit patterns -> int64 tensor of uint32 values."""
    return seeds.to(torch.int64) & _MASK


def as_int32_bits(seeds: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 tensor with the same bit pattern."""
    s = seeds.to(torch.int64) & _MASK
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def cell_seeds(base_seed: int, cells: int, device=None) -> torch.Tensor:
    """(cells,) int32 bit patterns of uint32 stream seeds, one per lane (the
    kernel's storage): a Weyl sequence off the base seed, mixed twice."""
    idx = torch.arange(cells, dtype=torch.int64, device=device)
    x = ((idx * _GOLD) + (int(base_seed) & _MASK)) & _MASK
    return as_int32_bits(mix32(mix32(x)))


def slice_seeds(base_seed: int, slice_index: int, cells: int,
                device=None) -> torch.Tensor:
    """(cells,) streams for slice ``slice_index`` of a campaign: the base
    seed offset by a per-slice Weyl constant before the per-lane split."""
    base = (int(base_seed) * _SLICE_GOLD + int(slice_index) * _SLICE_OFF) & _MASK
    return cell_seeds(base, cells, device)


def _uniform24(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash -> f32 uniform in (0, 1] from the top 24 bits (exact)."""
    return ((h >> 8).to(torch.float32) + 1.0) * _INV_2_24


def normal_pair(seed: torch.Tensor, counter):
    """Two standard normals per lane via Box-Muller.  ``seed``: (n,) uint32
    values (int64, see ``as_uint32``); ``counter``: a Python int or an int64 tensor broadcastable to
    ``seed`` (uint32 arithmetic, wrapped)."""
    base = seed ^ mix32(((counter * _GOLD) + 1) & _MASK)
    h1 = mix32(base)
    h2 = mix32(base ^ _M2)
    u1 = _uniform24(h1)
    u2 = _uniform24(h2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = _TWO_PI * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def thermal_draws(seed: torch.Tensor, step):
    """Six standard normals per lane for one LLG step: ((x1, y1, z1),
    (x2, y2, z2)), the thermal field directions of sublattice 1 and 2.
    Counters ``3*step + {0, 1, 2}`` (uint32, wrapped)."""
    step_u = (step * 3) & _MASK
    a0, b0 = normal_pair(seed, step_u)
    a1, b1 = normal_pair(seed, (step_u + 1) & _MASK)
    a2, b2 = normal_pair(seed, (step_u + 2) & _MASK)
    return (a0, a1, a2), (b0, b1, b2)
