"""ctypes bindings of the analog GEMM sources — ``csrc/analog_mac.cu`` (the
bit-line MAC B3, a float32 SIMT mainloop), ``csrc/fake_analog.cu`` (the
fake-analog MVM B5, the same mainloop fed by a producer warpgroup that
replays the conductances) and ``csrc/xnor_gemm.cu`` (the XNOR GEMM B4,
tensor cores) — and of B5's operand sizing (``csrc/adc_sizing.cu``), the
split-K rule the GEMMs share, and the launch path of their wrappers.
Nothing is built or loaded until a wrapper launches on a CUDA tensor.

Split-K.  A grid whose output tiles cannot fill the card's SMs cuts K into
``splits`` contiguous chunks of whole BK steps (``k_range`` in
``csrc/split_k.cuh``); each block sums its chunk in K order into a float32
workspace, and a second kernel (the reduce pass) adds the partials in split
order and applies the epilogue.  ``split_count`` is a plain function of
(M, N, K), the kernel's tile (read from its library) and the SM count: at
most one wave of blocks, no chunk without a K step, and 1 when the tiles
alone fill the SMs.  B5 takes its split count from B3's tile
(``plan(..., split_tile="analog_mac")``) and has B3's BK, so the two add
the same products in the same order.

Counts.  Each wrapper keeps ``launches`` (launches of its mainloop kernel:
one per call on a CUDA tensor), ``reduce_launches`` (launches of the
reduce pass: one per call that splits K) and ``launch_shapes`` (mainloop
launches by (M, K, N)); ``reset_counts`` sets them to zero.

The launch path is kept short on the host: the device index and the raw
current stream go to the C launcher, which makes the device current itself.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

_ARGTYPES = {
    "analog_mac": {
        "bitline_mac_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _P],
        "analog_mac_tile": [_I],
    },
    "fake_analog": {
        "fake_analog_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
        "fake_analog_tile": [_I],
    },
    "xnor_gemm": {
        "xnor_gemm_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P],
        "xnor_gemm_tile": [_I],
    },
    "adc_sizing": {
        "adc_aux_launch": [_P] * 12 + [_I, _P, _I, _D, _D, _D, _D, _I, _I,
                                        _D, _I, _P],
    },
}


@functools.lru_cache(maxsize=None)
def library(name: str = "analog_mac") -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with its C functions typed."""
    lib = build.load(name)
    for fn, argtypes in _ARGTYPES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def tile(name: str) -> tuple:
    """(BM, BN, BK) of the block tile of ``csrc/<name>.cu``, from the
    library itself (its ``<name>_tile``)."""
    get = getattr(library(name), f"{name}_tile")
    return tuple(get(i) for i in range(3))


def split_count(M: int, N: int, K: int, tile, n_sm: int) -> int:
    """Number of K chunks for an (M, K) @ (K, N) launch of ``tile``."""
    bm, bn, bk = tile
    tiles = -(-M // bm) * -(-N // bn)
    steps = -(-K // bk)
    return max(1, min(n_sm // tiles, steps))


def workspace(splits: int, M: int, N: int, device) -> torch.Tensor | None:
    """The float32 partials of a split launch (None when ``splits`` is 1)."""
    if splits == 1:
        return None
    return torch.empty((splits, M, N), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned(*ts: torch.Tensor) -> bool:
    """Every tensor's data on a 16-byte boundary (16-byte copies allowed)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def gemm_shapes(name: str, a: torch.Tensor, b: torch.Tensor):
    """(M, K, N) of ``a (M, K) @ b (K, N)``; raises on anything else."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: need (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    return a.shape[0], a.shape[1], b.shape[1]


def cuda_index(name: str, *ts: torch.Tensor) -> int:
    """The index of the one CUDA device holding every operand (the kernel's
    only input); raises otherwise."""
    index = ts[0].get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: unsupported device {t.device} (CPU "
                             f"tensors run the plain version, CUDA tensors "
                             f"the kernel)")
    return index


def plan(name: str, M: int, K: int, N: int, like: torch.Tensor,
         split_tile: str | None = None):
    """(library, splits, workspace) of an (M, K) @ (K, N) launch of
    ``csrc/<name>.cu`` on the device of ``like``, K split by the tile of
    ``csrc/<split_tile>.cu`` (default: its own).  The workspace holds the
    float32 partials of a split launch (None when ``splits`` is 1)."""
    lib = library(name)
    splits = split_count(M, N, K, tile(split_tile or name),
                         sm_count(like.get_device()))
    return lib, splits, workspace(splits, M, N, like.device)


def launch(name: str, fn, index: int, *args) -> None:
    """Call a C launcher on the current stream of CUDA device ``index`` and
    raise if the launch was refused (no fallback)."""
    err = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def count(wrapper, M: int, K: int, N: int, splits: int) -> None:
    """Count one mainloop launch (and its reduce pass when K was split)."""
    wrapper.launches += 1
    wrapper.reduce_launches += splits > 1
    wrapper.launch_shapes[(M, K, N)] += 1


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        w.reduce_launches = 0
        w.launch_shapes = collections.Counter()


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()
