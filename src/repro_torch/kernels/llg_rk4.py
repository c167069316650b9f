"""Wrapper of the CUDA LLG campaign kernel (``csrc/llg_rk4.cu``).

The kernel replaces the Pallas TPU kernels ``_llg_kernel`` and
``_llg_thermal_kernel`` of ``repro.kernels.llg_rk4``; see the source for the
layout and what bounds it.  ``llg_rk4_kernel`` has the signature of the
reference's ``llg_rk4_pallas`` (minus ``interpret``):

* a CPU ``state`` runs the plain PyTorch version ``ref.ref_llg_rk4``;
* a CUDA ``state`` launches the kernel on the current stream, without
  synchronising, or raises — there is no fallback.

``out=`` names the ``(8, cells)`` float32 tensor the result is written
into; ``out=state`` donates the state block to the launch (the torch
meaning of the reference's ``donate_argnums=(0,)``): no second block is
allocated, and the result is bit-identical to an undonated launch, since
every thread reads its lane's rows before any thread of that lane writes
them (``csrc/llg_rk4.cu``).

``llg_rk4_kernel.launches`` counts kernel launches (plain calls do not
count) and ``llg_rk4_kernel.launch_layouts`` counts them by ``(cells,
n_sublattices, C, T, P, V)``, V = 1 for the variation instance (per-lane
alpha, B_k and g_scale rows); ``reset_counts()`` zeroes both.

Layout.  A launch maps each 512-lane exit group onto C blocks (a
thread-block cluster when the chunked exit votes across them) with T
threads per lane (T = 2 splits an AFMTJ lane's two sublattices over two
threads) and, if P = 1, noise producer threads that draw the Brown-field
normals a batch of steps ahead (chunked thermal launches, C >= 8); see
``csrc/llg_rk4.cu``.  ``layout_rule`` picks (C, T, P) from the lane count
and the card's SM count; ``layout=`` forces one.  Every layout is
bit-identical to every other and to the plain version.

The scalar constants (``kernel_consts``) are the ones the plain
version folds in double precision — ``1 + alpha^2``, ``0.5 dt``,
``dt / 6``, the Julliere conductance terms — rounded once to float32 when
packed; products the plain version evaluates in float32, such as
``-GAMMA * (beta * a_J)``, the kernel evaluates in float32 in the same
order.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core.params import GAMMA, DeviceParams
from repro_torch.kernels import build, noise
from repro_torch.kernels.ref import CELL_TILE, ROWS, VAR_ROWS, ref_llg_rk4

AUX_ROWS = 2          # aux plane: row 0 = per-lane sigma [T], row 1 = budget
VAR_AUX_ROWS = AUX_ROWS + VAR_ROWS
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # blocks per exit group (C)
PRODUCER_BATCH = 8       # P = 1: steps per batch; the chunk is a multiple
PRODUCER_MIN_C = 8       # P = 1: at most 64 lanes per block
# the largest launch, in exit groups, that the rule spreads: on an H100
# (132 SMs; chip_smoke.py phases 4 and 4b) the rule's layout beat C = 1,
# T = 1 at launches of 1, 8, 16, 32 and 64 groups and every layout lost
# or tied at 128; larger launches keep C = 1, T = 1
SPREAD_MAX_GROUPS = 64
# the sizes above, compiled into csrc/llg_rk4.cu as -D flags
BUILD_DEFINES = (("LLG_GROUP", CELL_TILE),
                 ("LLG_MAX_CLUSTER", CLUSTER_SIZES[-1]),
                 ("LLG_BATCH", PRODUCER_BATCH),
                 ("LLG_PRODUCER_MIN_C", PRODUCER_MIN_C))


def layout_rule(cells: int, nsub: int, sm_count: int,
                producers: bool = True) -> tuple:
    """``(C, T, P)`` for a launch of ``cells`` lanes on a card of
    ``sm_count`` SMs; ``producers`` says whether the launch can take noise
    producers (``takes_producers``).  Launches of at most
    ``SPREAD_MAX_GROUPS`` exit groups, and fewer than ``sm_count``, take
    the smallest C with groups x C >= sm_count (16 at most), two threads
    per lane where there are two sublattices, and noise producers where
    the launch takes them, with C raised to ``PRODUCER_MIN_C`` for them;
    every other launch keeps (1, 1, 0)."""
    groups = -(-int(cells) // CELL_TILE)
    if groups > SPREAD_MAX_GROUPS or groups >= sm_count:
        return 1, 1, 0
    c = next((c for c in CLUSTER_SIZES if groups * c >= sm_count),
             CLUSTER_SIZES[-1])
    if producers:
        c = max(c, PRODUCER_MIN_C)
    return c, (2 if nsub == 2 else 1), int(producers)


def check_layout(layout, nsub: int) -> tuple:
    """``layout`` as a ``(C, T, P)`` tuple of ints (a ``(C, T)`` pair means
    P = 0), or ValueError: C a power of two up to 16, T 1 or 2, T = 2 only
    with two sublattices, P 0 or 1, P = 1 only with C >= 8."""
    if not (isinstance(layout, (tuple, list)) and len(layout) in (2, 3) and
            all(type(x) is int for x in layout)):
        raise ValueError(f"layout must be a (C, T) or (C, T, P) tuple of "
                         f"ints, got {layout!r}")
    c, t, prod = (*layout, 0)[:3]
    if c not in CLUSTER_SIZES:
        raise ValueError(f"layout C must be one of {CLUSTER_SIZES}, got {c}")
    if t not in (1, 2):
        raise ValueError(f"layout T must be 1 or 2, got {t}")
    if t == 2 and nsub != 2:
        raise ValueError("layout T = 2 splits two sublattices over two "
                         f"threads; this device has {nsub}")
    if prod not in (0, 1):
        raise ValueError(f"layout P must be 0 or 1, got {prod}")
    if prod and c < PRODUCER_MIN_C:
        raise ValueError(f"layout P = 1 (noise producers) needs C >= "
                         f"{PRODUCER_MIN_C}, got C = {c}")
    return c, t, prod


def takes_producers(thermal: bool, chunk: int) -> bool:
    """Whether a launch can run noise producers (P = 1): the chunked
    thermal kernel with a chunk of whole producer batches."""
    return thermal and chunk > 0 and chunk % PRODUCER_BATCH == 0


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib = build.load("llg_rk4", BUILD_DEFINES)
    if not getattr(lib, "_repro_typed", False):
        lib.llg_rk4_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
            + [ctypes.c_int] * 3)
        lib.llg_rk4_launch.restype = ctypes.c_int
        lib.llg_rk4_error_string.argtypes = [ctypes.c_int]
        lib.llg_rk4_error_string.restype = ctypes.c_char_p
        lib.llg_rk4_n_consts.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_out(out: torch.Tensor, state: torch.Tensor) -> None:
    """ValueError unless ``out`` can receive the result of ``state``'s
    launch: contiguous (8, cells) float32 on its device, and either
    ``state`` itself or disjoint from it."""
    if (out.device != state.device or out.dtype != torch.float32
            or tuple(out.shape) != tuple(state.shape)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(state.shape)} "
                         f"float32 tensor on {state.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if out.data_ptr() == state.data_ptr() and state.is_contiguous():
        return
    size = 4 * out.numel()
    a0, b0 = out.data_ptr(), state.data_ptr()
    span = state.element_size() * (
        1 + sum((n - 1) * st for n, st in zip(state.shape, state.stride())))
    if a0 < b0 + span and b0 < a0 + size:
        raise ValueError("out overlaps state without being state itself")


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
    layout=None,                  # optional (C, T[, P]); None = layout_rule
    out: torch.Tensor | None = None,   # optional (8, cells) f32 result block
) -> torch.Tensor:
    """Advance the ``(8, cells)`` block ``n_steps`` RK4 steps (see
    ``ref.ref_llg_rk4`` for the contract).  ``layout`` is checked on every
    device and only steers the CUDA launch: the plain version has none.
    ``out`` receives the result (``out=state`` donates the state block);
    it must be a contiguous ``(8, cells)`` float32 tensor on the state's
    device that is ``state`` itself or shares no memory with it."""
    if seeds is not None and seeds.dtype != torch.int32:
        raise ValueError(f"seeds must hold int32 bit patterns (noise."
                         f"cell_seeds), got {seeds.dtype}")
    if layout is not None:
        layout = check_layout(layout, p.n_sublattices)
        if layout[2] and not takes_producers(seeds is not None, chunk):
            raise ValueError(
                f"layout P = 1 (noise producers) needs the chunked thermal "
                f"kernel with a chunk that is a multiple of "
                f"{PRODUCER_BATCH}; got seeds={seeds is not None}, "
                f"chunk={chunk}")
    if out is not None:
        _check_out(out, state)
    if state.device.type == "cpu":
        return ref_llg_rk4(state, p, dt, n_steps, switch_threshold,
                           thermal_sigma=thermal_sigma, seeds=seeds,
                           step_budget=step_budget, chunk=chunk,
                           lane_params=lane_params, out=out)
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
    if layout is None:
        layout = layout_rule(cells, p.n_sublattices, sm_count(dev.index),
                             takes_producers(seeds is not None, chunk))
    if out is None:
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
            consts, stream, *layout)
    if err != 0:
        raise RuntimeError(f"llg_rk4 kernel launch with layout (C, T, P) = "
                           f"{layout} failed: {err}, "
                           f"{lib.llg_rk4_error_string(err).decode()}")
    llg_rk4_kernel.launches += 1
    llg_rk4_kernel.launch_layouts[(cells, p.n_sublattices, *layout,
                                   int(variation))] += 1
    return out


def reset_counts() -> None:
    llg_rk4_kernel.launches = 0
    llg_rk4_kernel.launch_layouts = collections.Counter()


reset_counts()
