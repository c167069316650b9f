"""Wrapper of the CUDA LLG campaign kernel (``csrc/llg_rk4.cu``).

The kernel replaces the Pallas TPU kernels ``_llg_kernel`` and
``_llg_thermal_kernel`` of ``repro.kernels.llg_rk4``; see the source for the
layout and what bounds it.  ``llg_rk4_kernel`` has the signature of the
reference's ``llg_rk4_pallas`` (minus ``interpret``):

* a CPU ``state`` runs the plain PyTorch version ``ref.ref_llg_rk4``;
* a CUDA ``state`` launches the kernel on the current stream, without
  synchronising, or raises — there is no fallback.

``llg_rk4_kernel.launches`` counts kernel launches (plain calls do not
count).  The scalar constants (``kernel_consts``) are the ones the plain
version folds in double precision — ``1 + alpha^2``, ``0.5 dt``,
``dt / 6``, the Julliere conductance terms — rounded once to float32 when
packed; products the plain version evaluates in float32, such as
``-GAMMA * (beta * a_J)``, the kernel evaluates in float32 in the same
order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.params import GAMMA, DeviceParams
from repro_torch.kernels import build, noise
from repro_torch.kernels.ref import CELL_TILE, ROWS, VAR_ROWS, ref_llg_rk4

AUX_ROWS = 2          # aux plane: row 0 = per-lane sigma [T], row 1 = budget
VAR_AUX_ROWS = AUX_ROWS + VAR_ROWS


def kernel_consts(p: DeviceParams, dt: float, switch_threshold: float) -> list:
    """The ``LLGConsts`` struct of the kernel, as Python floats in field
    order (rounded to float32 when packed)."""
    g_p = 1.0 / p.r_parallel
    g_ap = 1.0 / p.r_antiparallel
    return [
        -GAMMA, GAMMA, p.beta_flt, p.alpha, 1.0 + p.alpha**2, p.b_aniso,
        -p.b_exchange, 0.5 * (g_p + g_ap), 0.5 * (g_p - g_ap),
        p.stt_prefactor, p.area, 0.5 * dt, dt, dt / 6.0, -switch_threshold,
        noise._TWO_PI,
    ]


def _library() -> ctypes.CDLL:
    lib = build.load("llg_rk4")
    if not getattr(lib, "_repro_typed", False):
        lib.llg_rk4_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
        lib.llg_rk4_launch.restype = ctypes.c_int
        lib.llg_rk4_n_consts.restype = ctypes.c_int
        lib.llg_rk4_block_size.restype = ctypes.c_int
        assert lib.llg_rk4_block_size() == CELL_TILE
        lib._repro_typed = True
    return lib


def _lane_row(x, cells: int, device) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=device),
        (cells,)).contiguous()


def llg_rk4_kernel(
    state: torch.Tensor,          # (8, cells) f32
    p: DeviceParams,
    dt: float,
    n_steps: int,
    switch_threshold: float = 0.9,
    thermal_sigma=0.0,            # scalar or (cells,) f32 per-lane Brown sigma
    seeds: torch.Tensor | None = None,   # (cells,) int32 bits of uint32 seeds
    step_budget=None,             # optional (cells,) f32 per-lane step budget
    chunk: int = 0,               # >0: early-exit chunk size (steps)
    lane_params=None,             # optional (3, cells) f32: alpha, B_k, g_scale
) -> torch.Tensor:
    """Advance the ``(8, cells)`` block ``n_steps`` RK4 steps (see
    ``ref.ref_llg_rk4`` for the contract)."""
    if seeds is not None and seeds.dtype != torch.int32:
        raise ValueError(f"seeds must hold int32 bit patterns (noise."
                         f"cell_seeds), got {seeds.dtype}")
    if state.device.type == "cpu":
        return ref_llg_rk4(state, p, dt, n_steps, switch_threshold,
                           thermal_sigma=thermal_sigma, seeds=seeds,
                           step_budget=step_budget, chunk=chunk,
                           lane_params=lane_params)
    if state.device.type != "cuda":
        raise ValueError(f"llg_rk4_kernel: unsupported device {state.device}")
    if state.dtype != torch.float32 or state.dim() != 2 or state.shape[0] != ROWS:
        raise ValueError(f"state must be (8, cells) float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    cells = state.shape[1]
    if cells == 0 or cells % CELL_TILE:
        raise ValueError(f"cells must be a positive multiple of {CELL_TILE}, "
                         f"got {cells}")
    if p.n_sublattices not in (1, 2):
        raise ValueError(f"n_sublattices must be 1 or 2, got {p.n_sublattices}")
    state = state.contiguous()
    dev = state.device
    if seeds is None:
        if not (isinstance(thermal_sigma, (int, float)) and thermal_sigma == 0.0):
            raise ValueError("thermal path needs per-cell stream seeds")
        if step_budget is not None or lane_params is not None:
            raise ValueError("step budgets and variation rows ride the "
                             "thermal kernel (pass seeds)")
        aux = None
        variation = False
    else:
        if seeds.device != dev or seeds.numel() != cells:
            raise ValueError("seeds must be (cells,) on the state's device")
        seeds = seeds.reshape(cells).contiguous()
        rows = [_lane_row(thermal_sigma, cells, dev),
                _lane_row(float(n_steps) if step_budget is None
                          else step_budget, cells, dev)]
        variation = lane_params is not None
        if variation:
            lp = torch.as_tensor(lane_params, dtype=torch.float32, device=dev)
            if lp.shape != (VAR_ROWS, cells):
                raise ValueError(f"lane_params must be (3, {cells}), got "
                                 f"{tuple(lp.shape)}")
            rows += list(lp.unbind(0))
        aux = torch.stack(rows).contiguous()
    out = torch.empty_like(state)
    lib = _library()
    vals = kernel_consts(p, dt, switch_threshold)
    assert len(vals) == lib.llg_rk4_n_consts()
    consts = (ctypes.c_float * len(vals))(*vals)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.llg_rk4_launch(
            state.data_ptr(),
            None if seeds is None else seeds.data_ptr(),
            None if aux is None else aux.data_ptr(),
            out.data_ptr(), cells, int(n_steps), int(chunk),
            int(p.n_sublattices), int(seeds is not None), int(variation),
            consts, stream)
    if err != 0:
        raise RuntimeError(f"llg_rk4 kernel launch failed: cudaError {err}")
    llg_rk4_kernel.launches += 1
    return out


llg_rk4_kernel.launches = 0
