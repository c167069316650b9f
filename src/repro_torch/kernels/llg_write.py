"""Wrapper of the CUDA single-junction write kernel (``csrc/llg_write.cu``).

The kernel runs the write loop of ``core.device.simulate_write`` and
``write_sweep`` (the reference's ``lax.scan`` in ``repro.core.device``):
one lane per drive voltage, a fixed horizon, the self-consistent a_J,
and optionally a per-lane junction conductance factor ``g_scale`` (a
sampled process corner, ``core.params.DeviceSample``) on the drive and on
the energy sum.  ``llg_write_kernel`` has the contract of
``ref.ref_llg_write``:

* CPU tensors run the plain PyTorch version ``ref.ref_llg_write``;
* CUDA tensors launch the kernel on the current stream, without
  synchronising, or raise — there is no fallback.

``llg_write_kernel.launches`` counts kernel launches (plain calls do not
count); ``reset_counts()`` zeroes it.  The scalar constants are
``llg_rk4.kernel_consts`` (the same ``LLGConsts`` struct), with the
switching threshold 0.9 of the write.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.params import DeviceParams
from repro_torch.kernels import build
from repro_torch.kernels.llg_rk4 import kernel_consts
from repro_torch.kernels.ref import ref_llg_write

SWITCH_THRESHOLD = 0.9


def _library() -> ctypes.CDLL:
    lib = build.load("llg_write")
    if not getattr(lib, "_repro_typed", False):
        lib.llg_write_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.POINTER(ctypes.c_float),
               ctypes.c_void_p])
        lib.llg_write_launch.restype = ctypes.c_int
        lib.llg_write_error_string.argtypes = [ctypes.c_int]
        lib.llg_write_error_string.restype = ctypes.c_char_p
        lib.llg_write_n_consts.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def llg_write_kernel(
    m0: torch.Tensor,             # (lanes, n_sub, 3) f32 initial states
    voltages: torch.Tensor,       # (lanes,) f32 drive voltages
    p: DeviceParams,
    dt: float,
    n_steps: int,
    down: bool = True,
    g_scale: torch.Tensor | None = None,   # optional (lanes,) f32 factors
) -> tuple:
    """``(m, t_switch, switched, energy)`` after ``n_steps`` write steps
    (see ``ref.ref_llg_write``)."""
    if m0.device.type == "cpu":
        return ref_llg_write(m0, voltages, p, dt, n_steps, down, g_scale)
    if m0.device.type != "cuda":
        raise ValueError(f"llg_write_kernel: unsupported device {m0.device}")
    nsub = p.n_sublattices
    if nsub not in (1, 2):
        raise ValueError(f"n_sublattices must be 1 or 2, got {nsub}")
    if (m0.dtype != torch.float32 or m0.dim() != 3
            or tuple(m0.shape[1:]) != (nsub, 3) or m0.shape[0] == 0):
        raise ValueError(f"m0 must be (lanes, {nsub}, 3) float32 with "
                         f"lanes >= 1, got {tuple(m0.shape)} {m0.dtype}")
    lanes = m0.shape[0]
    if (voltages.device != m0.device or voltages.numel() != lanes
            or voltages.dtype != torch.float32):
        raise ValueError("voltages must be (lanes,) float32 on m0's device")
    if g_scale is not None and (g_scale.device != m0.device
                                or g_scale.numel() != lanes
                                or g_scale.dtype != torch.float32):
        raise ValueError("g_scale must be (lanes,) float32 on m0's device")
    dev = m0.device
    m0 = m0.contiguous()
    volts = voltages.reshape(lanes).contiguous()
    if g_scale is not None:
        g_scale = g_scale.reshape(lanes).contiguous()
    out = torch.empty((lanes, 3 * nsub + 3), dtype=torch.float32, device=dev)
    lib = _library()
    vals = kernel_consts(p, dt, SWITCH_THRESHOLD)
    assert len(vals) == lib.llg_write_n_consts()
    consts = (ctypes.c_float * len(vals))(*vals)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.llg_write_launch(m0.data_ptr(), volts.data_ptr(),
                                   None if g_scale is None
                                   else g_scale.data_ptr(),
                                   out.data_ptr(), lanes, int(n_steps), nsub,
                                   1.0 if down else -1.0, consts, stream)
    if err != 0:
        raise RuntimeError(f"llg_write kernel launch failed: {err}, "
                           f"{lib.llg_write_error_string(err).decode()}")
    llg_write_kernel.launches += 1
    m = out[:, :3 * nsub].reshape(lanes, nsub, 3)
    return m, out[:, 3 * nsub], out[:, 3 * nsub + 1] != 0, out[:, 3 * nsub + 2]


def reset_counts() -> None:
    llg_write_kernel.launches = 0


reset_counts()
