"""ctypes binding of ``csrc/analog_mac.cu``, the CUDA source of the three
analog MAC kernels (bit-line MAC, XNOR GEMM, fake-analog MVM), and the
operand checks their wrappers share.  Nothing is built or loaded until a
wrapper launches on a CUDA tensor."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    lib = build.load("analog_mac")
    if not getattr(lib, "_repro_typed", False):
        lib.bitline_mac_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                           ctypes.c_float, _P]
        lib.xnor_gemm_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _P]
        lib.fake_analog_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _P]
        for f in (lib.bitline_mac_launch, lib.xnor_gemm_launch,
                  lib.fake_analog_launch, lib.analog_mac_block_threads):
            f.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def gemm_shapes(name: str, a: torch.Tensor, b: torch.Tensor):
    """(M, K, N) of ``a (M, K) @ b (K, N)``; raises on anything else."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: need (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    return a.shape[0], a.shape[1], b.shape[1]


def check_cuda(name: str, *ts: torch.Tensor) -> None:
    """Every operand a CUDA tensor on one device (the kernel's only input)."""
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: unsupported device {t.device} (CPU "
                             f"tensors run the plain version, CUDA tensors "
                             f"the kernel)")


def launch(name: str, fn, *args) -> None:
    """Call a C launcher on the current stream of the operands' device and
    raise if the launch was refused (no fallback)."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()
