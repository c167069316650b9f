"""Monte-Carlo campaign engine: one kernel launch for the whole campaign.

Port of ``repro.campaign.engine``.  Every campaign axis that is not
post-processing rides the kernel's lanes: voltage x sample x temperature
(Brown's sigma is a per-lane input) x process corner (per-lane alpha, B_k
and conductance-factor rows on the kernel's variation plane,
``grid.pack_variation``), pulse width falls out of the recorded
first-crossing steps.  The kernel integrates in chunks and a block of lanes
leaves as soon as each of its lanes has crossed or used its step budget
(``EARLY_EXIT_CHUNK``); the horizon passed to it is rounded up to a rung
(a power of two, or with ``horizon="log"`` the geometric ladder of
``grid.log_horizon_bucket``) while the budget row stops real lanes at the
true horizon, so crossing rows equal a fixed-horizon run's.  Corner count
and values are launch data: every variation campaign runs the kernel's one
variation instance, whatever its corners.

Both device kinds integrate through ``kernels.llg_rk4.llg_rk4_kernel``: the
CUDA kernel for CUDA tensors (dual- or single-sublattice), its plain
PyTorch version for CPU tensors.  Results are reduced into WER and
latency-percentile surfaces and cached on disk (``cache.py``).

Scale-out (DESIGN.md §13, §14):

* ``max_cells_per_launch`` splits a campaign along (corner x temperature)
  slice boundaries; every launch (and in streaming mode its reduction) is
  enqueued before the first copy to the host, which is the first sync.
  Completed launches checkpoint through the store, so a killed campaign
  resumes bit-identically;
* ``reduce="stream"`` reduces each launch on its device to exact WER counts
  and a first-crossing histogram (``_reduce_rows``), so the host receives
  O(grid points) bytes whatever the sample count;
* ``devices=`` splits each launch's lanes into contiguous shares, one
  kernel call per device, padded with frozen lanes rather than run on fewer
  devices (``_device_plan``);
* ``donate=True`` passes the state block as the kernel's ``out``, so a
  launch allocates no second block;
* a ``launch.mesh.CampaignMesh`` with several processes splits whole
  launches between processes, which meet only in the store (claims and
  slice checkpoints), with no collective.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.campaign import cache as _cache
from repro_torch.campaign.grid import (CampaignGrid, bucket_cells,
                                       log_horizon_bucket, next_pow2,
                                       pack_campaign, pack_soa,
                                       pack_variation)
from repro_torch.core.montecarlo import thermal_sigma
from repro_torch.core.params import DeviceParams
from repro_torch.kernels import noise
from repro_torch.kernels.llg_rk4 import llg_rk4_kernel
from repro_torch.kernels.ref import CELL_TILE
from repro_torch.launch.sharding import plan_cell_tiles

# Early-exit granularity [steps]: a block checks "is every lane done?" once
# per chunk.
EARLY_EXIT_CHUNK = 64


def backend_tag(device: torch.device) -> str:
    """Which path integrates on ``device``: the CUDA kernel or its plain
    PyTorch version."""
    return "cuda-kernel" if device.type == "cuda" else "cpu-plain"


def brown_sigma(p: DeviceParams, dt: float, temperature: Optional[float] = None
                ) -> float:
    """Brown's thermal-field std per component per step [T]."""
    if temperature is not None and temperature != p.temperature:
        p = dataclasses.replace(p, temperature=float(temperature))
    return thermal_sigma(p, dt)


def _quantize_steps(n_steps: int, horizon: str = "pow2") -> int:
    """Horizon passed to the kernel: the next power of two (``"pow2"``) or
    the next rung of the geometric ladder (``"log"``, for decade-spanning
    retention campaigns).  The per-lane budget row stops every real lane at
    the true horizon."""
    if horizon == "log":
        return log_horizon_bucket(n_steps)
    if horizon != "pow2":
        raise ValueError(f"horizon must be 'pow2' or 'log', got {horizon!r}")
    return next_pow2(n_steps)


# ------------------------------------------------------------ device plans
def _device_list(devices, dev: torch.device) -> List[torch.device]:
    """The devices a launch is split over: ``None`` = every visible device
    of ``dev``'s kind (one CPU), an int = that many of them (clamped to
    1..visible, as the reference clamps), a sequence = those devices, in
    order (one device may be named more than once)."""
    if devices is None or isinstance(devices, int):
        if dev.type == "cuda":
            visible = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            visible = [dev]
        if devices is None:
            return visible
        return visible[:max(1, min(int(devices), len(visible)))]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices names no device")
    return out


def _device_plan(span_cells: int, devices, device=None) -> Tuple[int, int]:
    """Device count and padded lane width of one launch span.

    Never runs a span on fewer devices than asked: when the span's
    ``CELL_TILE`` tiles do not divide the device count (power-of-two
    buckets on 3, 5 or 6 devices), the span is padded with budget-0 lanes
    to the next whole number of tiles per device
    (``launch.sharding.plan_cell_tiles``).  Pad lanes are frozen at step 0
    and trimmed before any reduction, so crossing rows equal the
    one-device launch's."""
    n = len(_device_list(devices, resolve_device(device)))
    tiles = -(-span_cells // CELL_TILE)
    _, padded_tiles = plan_cell_tiles(tiles, n)
    return n, padded_tiles * CELL_TILE


def _pad_lanes(st, sd, sg, bd, lp, pad: int, p: DeviceParams):
    """Append ``pad`` frozen lanes (zero state, seed, sigma and budget;
    nominal variation rows: a zero alpha would divide 0 by 0) so a span
    fills its device plan exactly."""
    if pad == 0:
        return st, sd, sg, bd, lp
    f = torch.nn.functional.pad
    st, sd, sg, bd = f(st, (0, pad)), f(sd, (0, pad)), f(sg, (0, pad)), \
        f(bd, (0, pad))
    if lp is not None:
        fill = torch.tensor([[p.alpha], [p.b_aniso], [1.0]],
                            dtype=torch.float32, device=lp.device)
        lp = torch.cat([lp, fill.expand(3, pad)], dim=1)
    return st, sd, sg, bd, lp


def _integrate(state, seeds, sigma, budget, lane_params, *, p, dt: float,
               n_kernel: int, switch_threshold: float, chunk: int,
               devices: List[torch.device], donate: bool) -> torch.Tensor:
    """Advance an (8, cells) block whose width is a multiple of
    ``len(devices)`` tiles: device ``i`` integrates the ``i``-th contiguous
    share as its own kernel call (every lane integrates alone, so the
    shares' rows equal the whole block's).  ``donate`` passes each share's
    state as the kernel's ``out``; with one share on the block's own device
    that is ``state`` itself.  Returns the output block on ``state``'s
    device, without synchronising."""
    n = len(devices)
    share = state.shape[1] // n
    outs = []
    for i, d in enumerate(devices):
        cols = slice(i * share, (i + 1) * share)
        st = state[:, cols].to(d).contiguous()
        lp = (None if lane_params is None
              else lane_params[:, cols].to(d).contiguous())
        outs.append(llg_rk4_kernel(
            st, p, dt, n_kernel, switch_threshold,
            thermal_sigma=sigma[cols].to(d).contiguous(),
            seeds=seeds[cols].to(d).contiguous(),
            step_budget=budget[cols].to(d).contiguous(), chunk=chunk,
            lane_params=lp, out=st if donate else None))
    if n == 1:
        return outs[0].to(state.device)
    return torch.cat([o.to(state.device) for o in outs], dim=1)


# ------------------------------------------------- streaming reduction
# DESIGN.md §14: in streaming mode every launch is reduced on its device to
# what the surfaces need: WER counts per (slice, V, pulse) and a fixed-bin
# first-crossing histogram per (slice, V).  WER counts are exact: the dense
# surface compares f64(crossing_step) * dt > pulse, and
# ``_wer_threshold_steps`` finds on the host (in f64) the smallest integer
# step that satisfies it per pulse, so the device runs only integer
# compares.  Percentiles come from the histogram: exact while bins resolve
# single steps, within two bin widths otherwise
# (``CampaignResult.sketch_tolerance``).

# crossing steps ride the kernel's float32 row 7: exact integers only below
# 2**24, which the integer compares rely on
_STREAM_MAX_STEPS = 1 << 24


def _wer_threshold_steps(pulse_widths, dt: float, n_steps: int) -> np.ndarray:
    """Smallest integer step count per pulse with ``f64(k) * dt > pulse``:
    counting ``crossing_step >= k`` reproduces the dense f64 comparison."""
    out = []
    for pl in pulse_widths:
        k = int(math.ceil(pl / dt))
        while np.float64(k) * dt <= pl:
            k += 1
        while k > 0 and np.float64(k - 1) * dt > pl:
            k -= 1
        assert k <= n_steps, (k, n_steps, pl)   # grid.n_steps covers pulses
        out.append(k)
    return np.asarray(out, np.int32)


def _hist_step_values(n_steps: int, n_bins: int) -> np.ndarray:
    """Lower-edge crossing step of every histogram bin (f64).  With
    ``n_bins >= n_steps`` a bin is one step; otherwise bin ``b`` spans
    steps ``[ceil(b n_steps / n_bins), ceil((b + 1) n_steps / n_bins))``
    and its lower edge stands for every sample in it."""
    if n_bins >= n_steps:
        return np.arange(n_bins, dtype=np.float64)
    return np.ceil(np.arange(n_bins, dtype=np.float64) * n_steps / n_bins)


def _count_dtype(n_s: int) -> torch.dtype:
    """The narrowest integer type that holds a count of ``n_s`` samples:
    the reduced payload leaves the device in it."""
    if n_s <= 255:
        return torch.uint8
    if n_s <= 32767:
        return torch.int16
    return torch.int32


def _reduce_rows(row7: torch.Tensor, kmin: torch.Tensor, *, n_slices: int,
                 slice_cells: int, n_v: int, n_s: int, n_steps: int,
                 n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduction of one launch's crossing row on its device.

    Returns ``(wer, hist)``: the ``(n_slices, n_v, n_p)`` counts of samples
    NOT switched by each pulse (exact) and the ``(n_slices, n_v, n_bins)``
    first-crossing histogram of switched samples, both in
    ``_count_dtype(n_s)``.  Bucket padding, device-plan padding and
    never-crossed lanes are excluded on the device; the counts are integer
    sums, exact in any order."""
    dev = row7.device
    rows = row7[: n_slices * slice_cells].reshape(n_slices, slice_cells)
    ki = torch.clamp(rows[:, : n_v * n_s], max=float(n_steps)).to(torch.int32)
    ki = ki.reshape(n_slices, n_v, n_s)
    wer = (ki[:, :, None, :] >= kmin[None, None, :, None]).sum(dim=-1)
    switched = ki < n_steps
    if n_bins >= n_steps:                       # one bin per step: exact
        bins = ki
    else:
        # the reference's float32 bin: floor(f32(ki) x f32(n_bins / n_steps))
        scale = torch.tensor(float(n_bins) / float(n_steps),
                             dtype=torch.float32, device=dev)
        bins = torch.floor(ki.to(torch.float32) * scale).to(torch.int32)
        bins = torch.clamp(bins, 0, n_bins - 1)
    cell = torch.arange(n_slices * n_v, dtype=torch.int32,
                        device=dev).reshape(n_slices, n_v, 1)
    spill = n_slices * n_v * n_bins                 # unswitched lanes
    flat = torch.where(switched, cell * n_bins + bins,
                       torch.full_like(bins, spill))
    hist = torch.bincount(flat.reshape(-1).to(torch.int64),
                          minlength=spill + 1)[:spill]
    dt_out = _count_dtype(n_s)
    return (wer.to(dt_out),
            hist.reshape(n_slices, n_v, n_bins).to(dt_out))


def _percentiles_from_hist(hist: np.ndarray, values: np.ndarray,
                           qs) -> np.ndarray:
    """Percentiles over switched samples from per-bin counts: the linear
    interpolation ``np.nanpercentile`` applies to the sorted samples,
    rebuilt from cumulative counts (which determine the sorted array).
    Cells where nothing switched give NaN, as the dense all-NaN slice."""
    qs = np.asarray(qs, dtype=float)
    flat = hist.reshape(-1, hist.shape[-1])
    out = np.full((flat.shape[0], len(qs)), np.nan)
    for i, h in enumerate(flat):
        n = int(h.sum())
        if n == 0:
            continue
        cum = np.cumsum(h)
        pos = (qs / 100.0) * (n - 1)
        lo = np.floor(pos).astype(int)
        hi = np.ceil(pos).astype(int)
        v_lo = values[np.searchsorted(cum, lo, side="right")]
        v_hi = values[np.searchsorted(cum, hi, side="right")]
        # numpy's _lerp flips its anchor at t >= 0.5; so does this
        t = pos - lo
        lerp = v_lo + t * (v_hi - v_lo)
        flip = t >= 0.5
        lerp[flip] = v_hi[flip] - (v_hi[flip] - v_lo[flip]) * (1 - t[flip])
        out[i] = lerp
    return out.reshape(hist.shape[:-1] + (len(qs),))


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """One thermal ensemble integration."""
    final_state: np.ndarray      # (8, cells) SoA at loop exit
    crossing_steps: np.ndarray   # (cells,) first crossing (== n_steps: none)
    n_steps: int
    dt: float
    elapsed_s: float
    backend: str = ""

    @property
    def crossing_time(self) -> np.ndarray:
        return self.crossing_steps * self.dt

    @property
    def switched(self) -> np.ndarray:
        return self.crossing_steps < self.n_steps


def run_ensemble(
    p: DeviceParams,
    m0: torch.Tensor,                # (cells, n_sub, 3) initial states
    voltages,                        # (cells,) per-cell drive
    dt: float,
    n_steps: int,
    *,
    seed: int = 0,
    temperature: Optional[float] = None,
    switch_threshold: float = 0.9,
    devices=None,                    # None, a count, or a device list
    chunk: int = 0,
    lane_params=None,                # optional (3, cells) variation rows
    sigma_lanes=None,                # optional (cells,) per-lane Brown sigma
    horizon: str = "pow2",           # horizon ladder (chunk > 0)
    donate: bool = False,            # the state block is the kernel's out
    device=None,
) -> EnsembleResult:
    """Integrate an arbitrary thermal ensemble through the kernel path.

    ``temperature=None`` uses ``p.temperature``.  ``chunk > 0`` turns on
    chunked early exit: crossing rows equal the fixed-horizon run's, but
    ``final_state`` then holds the at-exit state, and the horizon given to
    the kernel is rounded up to a rung of ``horizon``'s ladder (the budget
    row stops real lanes at ``n_steps``).  ``lane_params`` ((3, cells):
    alpha, B_k, g_scale) switches on the kernel's per-lane variation plane
    and ``sigma_lanes`` replaces the scalar Brown sigma with a per-lane row
    (``VariationSpec.lane_rows`` gives both).  ``devices`` splits the lanes
    over several devices (see ``_device_list``; every lane keeps its stream
    seed, so the result equals the one-device run), ``donate`` writes each
    launch's result into its state block.  Never-switched lanes report
    ``crossing_steps == n_steps``.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    cells = m0.shape[0]
    state = pack_soa(torch.as_tensor(m0, dtype=f32, device=dev),
                     torch.as_tensor(voltages, dtype=f32, device=dev))
    padded = state.shape[1]
    if sigma_lanes is not None:
        sigma = torch.nn.functional.pad(
            torch.as_tensor(np.asarray(sigma_lanes, np.float64)
                            .astype(np.float32), device=dev),
            (0, padded - cells))
    else:
        sigma = torch.full((padded,), brown_sigma(p, dt, temperature),
                           dtype=f32, device=dev)
    budget = torch.where(torch.arange(padded, device=dev) < cells,
                         float(n_steps), 0.0).to(f32)
    if lane_params is not None:
        lp = np.asarray(lane_params, np.float64)
        assert lp.shape == (3, cells), (lp.shape, cells)
        fill = np.broadcast_to(np.array([[p.alpha], [p.b_aniso], [1.0]]),
                               (3, padded - cells))
        lane_params = torch.from_numpy(np.concatenate(
            [lp, fill], axis=1).astype(np.float32)).to(dev)
    seeds = noise.cell_seeds(seed, padded, dev)
    devs = _device_list(devices, dev)
    _, plan_cols = _device_plan(padded, devs, dev)
    state, seeds, sigma, budget, lane_params = _pad_lanes(
        state, seeds, sigma, budget, lane_params, plan_cols - padded, p)
    n_kernel = _quantize_steps(n_steps, horizon) if chunk > 0 else n_steps
    t0 = time.perf_counter()
    out = _integrate(state, seeds, sigma, budget, lane_params, p=p, dt=dt,
                     n_kernel=n_kernel,
                     switch_threshold=float(switch_threshold),
                     chunk=int(chunk), devices=devs, donate=donate)
    out = out.cpu().numpy()
    elapsed = time.perf_counter() - t0
    return EnsembleResult(
        final_state=out[:, :cells],
        crossing_steps=np.minimum(out[7, :cells].astype(np.float64),
                                  float(n_steps)),
        n_steps=n_steps, dt=dt, elapsed_s=elapsed, backend=backend_tag(dev))


@dataclasses.dataclass(frozen=True)
class CampaignResult:
    """WER / latency surfaces over the (T, V, pulse) axes of a grid, with a
    leading process-corner axis when the grid carries a ``VariationSpec``
    (``crossing_time`` is then (n_C, n_T, n_V, n_S), and every surface
    grows the same leading axis).

    ``reduced=True`` is the streaming variant: ``crossing_time`` is None
    (the lanes never left the device) and the surfaces come from
    ``wer_counts`` (exact) and the ``latency_hist`` sketch (exact while
    bins resolve single steps, within ``sketch_tolerance`` otherwise).
    ``host_bytes`` meters the bytes this process copied from the device:
    in dense mode each launch's row 7 (the port copies no other row;
    the reference meters its whole (8, cells) block), in streaming mode
    the counts and the histogram, in the narrowest integer type that holds
    ``n_samples`` (``_count_dtype``)."""
    grid: CampaignGrid
    backend: str                     # "cuda-kernel" or "cpu-plain"
    crossing_time: Optional[np.ndarray]  # (n_T, n_V, n_S) [s]; variation
                                     # grids: (n_C, n_T, n_V, n_S); None
                                     # when reduced
    elapsed_s: float                 # integration wall clock (0 on cache hit)
    from_cache: bool = False
    n_launches: int = 1              # kernel launches (0 on a cache hit)
    n_resumed: int = 0               # launches restored from slice checkpoints
    reduced: bool = False            # the streaming reduction ran
    wer_counts: Optional[np.ndarray] = None    # (..., n_T, n_V, n_P) int64
    latency_hist: Optional[np.ndarray] = None  # (..., n_T, n_V, n_bins) int32
    hist_values: Optional[np.ndarray] = None   # (n_bins,) bin lower edge [s]
    host_bytes: int = 0              # result bytes copied device -> host
    n_computed: int = 0              # launches integrated by this process

    @property
    def n_samples_total(self) -> int:
        if self.crossing_time is not None:
            return int(self.crossing_time.size)
        n_t, n_v, _, n_s = self.grid.shape
        return self.grid.n_corners * n_t * n_v * n_s

    @property
    def sketch_tolerance(self) -> float:
        """Error bound of the streamed latency percentiles [s]: 0 when bins
        resolve single steps, else two bin widths (one for the floor onto
        bin lower edges, one for the float32 bin index of
        ``_reduce_rows``).  Dense results are exact."""
        if not self.reduced:
            return 0.0
        n_bins = self.latency_hist.shape[-1]
        if n_bins >= self.grid.n_steps:
            return 0.0
        return 2.0 * self.grid.n_steps * self.grid.dt / n_bins

    @property
    def corners(self) -> Optional[Tuple[str, ...]]:
        """Corner names of the leading axis (None for nominal grids)."""
        return (None if self.grid.variation is None
                else self.grid.variation.corner_names)

    def wer_surface(self) -> np.ndarray:
        """(..., n_T, n_V, n_P) write-error rate: fraction of thermal
        samples NOT switched by the end of each pulse width (leading axis:
        process corners, on variation grids).  Bit-identical between dense
        and reduced results: an exact integer count over ``n_samples`` in
        f64 is the number the dense boolean mean gives."""
        if self.reduced:
            return (self.wer_counts.astype(np.float64)
                    / np.float64(self.grid.n_samples))
        pulses = np.asarray(self.grid.pulse_widths)
        ct = self.crossing_time[..., None, :]             # (..., V, 1, S)
        return (ct > pulses[:, None]).mean(axis=-1)

    def wer(self, t_index: int = 0, corner_index: int = 0) -> np.ndarray:
        """(n_V, n_P) slice at one temperature (and corner, if any)."""
        w = self.wer_surface()
        return w[corner_index, t_index] if w.ndim == 4 else w[t_index]

    def latency_percentiles(self, qs: Sequence[float] = (50.0, 99.0)
                            ) -> np.ndarray:
        """(..., n_T, n_V, len(qs)) switching-latency percentiles over
        switched samples (NaN where no sample switched; leading corner axis
        on variation grids)."""
        if self.reduced:
            return _percentiles_from_hist(self.latency_hist,
                                          self.hist_values, qs)
        horizon = self.grid.n_steps * self.grid.dt
        ct = np.where(self.crossing_time < horizon, self.crossing_time, np.nan)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "All-NaN slice encountered")
            out = np.nanpercentile(ct, np.asarray(qs, dtype=float), axis=-1)
        return np.moveaxis(out, 0, -1)

    def pulse_for_wer(self, wer_target: float, t_index: int = 0,
                      v_index: Optional[int] = None,
                      corner_index: Optional[int] = None) -> float:
        """Smallest grid pulse width whose WER <= target, at the lowest grid
        voltage by default (the worst-case drive); on a variation grid
        ``corner_index=None`` takes the worst corner at every pulse.
        Raises if none qualifies."""
        if v_index is None:
            v_index = int(np.argmin(self.grid.voltages))
        surface = self.wer_surface()
        if surface.ndim == 4:
            surface = (surface.max(axis=0) if corner_index is None
                       else surface[corner_index])
        w = surface[t_index][v_index]
        pulses = np.asarray(self.grid.pulse_widths)
        ok = np.nonzero(w <= wer_target)[0]
        if not ok.size:
            raise ValueError(
                f"no grid pulse meets WER<={wer_target:g} (best WER "
                f"{w.min():.3g} at {pulses[-1]*1e12:.0f} ps); widen "
                "pulse_widths or raise the drive voltage")
        return float(pulses[ok[0]])


def _launch_spans(n_slices: int, slice_cells: int,
                  max_cells: Optional[int]) -> List[Tuple[int, int]]:
    """Whole slices grouped into launches of at most ``max_cells`` lanes
    (one launch when ``max_cells`` is None)."""
    if max_cells is None:
        return [(0, n_slices)]
    per = max(1, int(max_cells) // slice_cells)
    return [(a, min(a + per, n_slices)) for a in range(0, n_slices, per)]


def _slice_key(key: str, a: int, b: int, chunk: int, horizon: str,
               kind: str = "slice-row7") -> str:
    """Content key of one launch span's checkpoint (DESIGN.md §13): the
    whole-campaign key plus what shapes the launch split, so a resume with
    another split or horizon never matches a stale slice.  ``kind`` keeps
    payloads apart: ``"slice-row7"`` the dense crossing row,
    ``"slice-reduced-<n_bins>"`` a streamed launch's counts."""
    return _cache.content_key({"campaign": key, "span": [int(a), int(b)],
                               "chunk": int(chunk), "horizon": horizon,
                               "kind": kind})


def run_campaign(
    p: DeviceParams,
    grid: CampaignGrid,
    *,
    use_cache: bool = True,
    cache_dir: Optional[str] = None,
    devices=None,
    chunk: int = EARLY_EXIT_CHUNK,
    max_cells_per_launch: Optional[int] = None,
    horizon: str = "pow2",
    checkpoint: Optional[bool] = None,
    max_retries: int = 2,
    retry_backoff_s: float = 0.25,
    on_slice_complete=None,
    reduce: str = "dense",
    n_bins: int = 512,
    donate: bool = False,
    mesh=None,
    device=None,
) -> CampaignResult:
    """Run (or cache-load) a full Monte-Carlo campaign.

    The whole (corner x T x V x S) grid rides the lanes of one kernel call
    on one device unless split.  ``chunk=0`` disables early exit and the
    rounded horizon (the exact fixed-horizon launch); ``horizon`` picks the
    ladder the horizon is rounded up to ("pow2", or "log" for
    decade-spanning retention sweeps).  Crossing rows do not depend on the
    ladder, so both cache under one key.  A one-launch variation grid pads
    the whole plane to a power-of-two bucket, so the corner count reaches
    the launch shape only through that bucket.

    ``max_cells_per_launch`` splits the campaign along slice boundaries into
    several launches, all enqueued before the first copy to the host.
    Crash resume (DESIGN.md §13): each completed launch's payload is
    checkpointed in the store (``checkpoint=None``: whenever caching is on
    and there is more than one launch), so a killed process re-runs only
    the launches it never finished, and the assembly is bit-identical to
    an uninterrupted run; slice checkpoints are retired once the
    whole-campaign entry is stored.  A launch that fails is retried up to
    ``max_retries`` times with exponential backoff (``retry_backoff_s``);
    ``on_slice_complete(i, n_launches)`` fires after each freshly computed
    launch is checkpointed.

    ``reduce="stream"`` reduces each launch on its device
    (``_reduce_rows``) and copies only the counts and the ``n_bins``-bin
    histogram: ``CampaignResult.reduced`` is then True, the WER surface is
    bit-identical to dense mode and percentiles are within
    ``sketch_tolerance``.  Streamed results cache under their own key.
    ``devices`` splits each launch over devices (``_device_list``), padded
    rather than run on fewer (``_device_plan``).  ``donate=True`` passes the
    state block as the kernel's ``out`` (no second (8, cells) block); a
    retry after a donated launch consumed the block packs it again (the
    draws are deterministic).  Donated and undonated launches run the same
    float32 operations: the results are bit-identical.

    ``mesh`` (a ``launch.mesh.CampaignMesh``) gives the device count
    (``mesh.n_devices``: the first that many of ``devices`` when it is a
    list) and, with ``mesh.process_count > 1``, splits whole launches
    between processes through the store: each claims launches
    (``cache.try_claim``), polls its peers' slice checkpoints and steals
    claims older than ``mesh.claim_ttl_s``.  This needs ``use_cache`` (the
    store is the only channel); every process returns the identical
    assembled result.
    """
    if reduce not in ("dense", "stream"):
        raise ValueError(f"reduce must be 'dense' or 'stream', got {reduce!r}")
    streaming = reduce == "stream"
    dev = resolve_device(device)
    backend = backend_tag(dev)
    if mesh is not None:
        devices = (mesh.n_devices if devices is None or isinstance(devices, int)
                   else list(devices)[:mesh.n_devices])
    devs = _device_list(devices, dev)
    multi = mesh is not None and mesh.process_count > 1
    spec = grid.variation
    n_t, n_v, n_p, n_s = grid.shape
    n_c = grid.n_corners
    expect_shape = ((n_c, n_t, n_v, n_s) if spec is not None
                    else (n_t, n_v, n_s))
    key = _cache.campaign_key(p, grid, backend)
    n_steps = grid.n_steps
    if streaming:
        if int(n_bins) < 1:
            raise ValueError(f"n_bins must be >= 1, got {n_bins}")
        if n_steps > _STREAM_MAX_STEPS:
            raise ValueError(
                "streaming WER relies on exact integer steps in the kernel's "
                f"f32 crossing row: n_steps={n_steps} > {_STREAM_MAX_STEPS}")
        # streamed entries live under a key of their own: another payload
        # family, which must never shadow (or be shadowed by) a dense entry
        red_key = _cache.content_key({"campaign": key, "kind": "reduced",
                                      "n_bins": int(n_bins), "v": 1})
        lead = (n_c, n_t) if spec is not None else (n_t,)
        expect_wer = lead + (n_v, n_p)
        expect_hist = lead + (n_v, int(n_bins))
        hist_values = _hist_step_values(n_steps, int(n_bins)) * grid.dt
        kmin = torch.as_tensor(
            _wer_threshold_steps(grid.pulse_widths, grid.dt, n_steps),
            device=dev)

        def _reduced_result(wer, hist, **kw):
            return CampaignResult(
                grid=grid, backend=backend, crossing_time=None, reduced=True,
                wer_counts=np.asarray(wer).astype(np.int64),
                latency_hist=np.asarray(hist).astype(np.int32),
                hist_values=hist_values, **kw)

    def _load_whole():
        """This mode's stored whole-campaign entry, or None."""
        if streaming:
            hit = _cache.load_arrays(red_key, cache_dir)
            if (hit is not None and "wer" in hit and "hist" in hit
                    and hit["wer"].shape == expect_wer
                    and hit["hist"].shape == expect_hist):
                return hit
            return None
        hit = _cache.load(key, cache_dir)
        return hit if (hit is not None and hit.shape == expect_shape) else None

    if use_cache:
        whole = _load_whole()
        if whole is not None:
            if streaming:
                return _reduced_result(whole["wer"], whole["hist"],
                                       elapsed_s=0.0, from_cache=True,
                                       n_launches=0)
            return CampaignResult(grid=grid, backend=backend,
                                  crossing_time=whole, elapsed_s=0.0,
                                  from_cache=True, n_launches=0)

    n_kernel = _quantize_steps(n_steps, horizon) if chunk > 0 else n_steps

    def _pack_inputs():
        """Pack the campaign's inputs: once up front, and again when a
        donated launch consumed the block before a retry (the draws are
        deterministic, so the new block equals the consumed one)."""
        if spec is None:
            st, sd, sg, bd, sp = pack_campaign(grid, p, dev)
            lp = None
        else:
            st, sd, sg, bd, lp, sp = pack_variation(grid, p, dev)
        return st, sd, sg, bd, lp, sp

    def _bucket_pad(st, sd, sg, bd, lp):
        # total-plane bucket: budget-0 padding with nominal rows
        return _pad_lanes(st, sd, sg, bd, lp,
                          bucket_cells(st.shape[1]) - st.shape[1], p)

    state, seeds, sigma, budget, lane_params, spans = _pack_inputs()
    n_slices = n_c * n_t
    slice_cells = state.shape[1] // n_slices
    launches = _launch_spans(n_slices, slice_cells, max_cells_per_launch)
    single_variation = spec is not None and len(launches) == 1
    if single_variation:
        state, seeds, sigma, budget, lane_params = _bucket_pad(
            state, seeds, sigma, budget, lane_params)
    consumed = False          # a donated launch wrote its result into state

    ckpt = ((use_cache and len(launches) > 1) if checkpoint is None
            else bool(checkpoint))
    if multi:
        if not use_cache:
            raise AssertionError(
                "multi-process campaigns rendezvous through the "
                "content-addressed store; use_cache=False has no channel to "
                "exchange slices")
        ckpt = True               # slice entries are the exchange channel
    skind = f"slice-reduced-{int(n_bins)}" if streaming else "slice-row7"

    def span_cols(a: int, b: int) -> Tuple[int, int]:
        c0, c1 = a * slice_cells, b * slice_cells
        if single_variation:
            c1 = state.shape[1]              # include the total-bucket pad
        return c0, c1

    def dispatch(a: int, b: int):
        """Enqueue one launch (and its reduction) without synchronising;
        returns its device payload."""
        nonlocal consumed
        c0, c1 = span_cols(a, b)
        _, plan_cols = _device_plan(c1 - c0, devs, dev)
        st, sd, sg, bd, lp = _pad_lanes(
            state[:, c0:c1], seeds[c0:c1], sigma[c0:c1], budget[c0:c1],
            None if lane_params is None else lane_params[:, c0:c1],
            plan_cols - (c1 - c0), p)
        # a donated launch may write into state itself: count it consumed
        # before the launch, which may fail after writing
        consumed = consumed or (donate and st.untyped_storage().data_ptr()
                                == state.untyped_storage().data_ptr())
        out = _integrate(st, sd, sg, bd, lp, p=p, dt=grid.dt,
                         n_kernel=n_kernel,
                         switch_threshold=float(grid.switch_threshold),
                         chunk=int(chunk), devices=devs, donate=donate)
        if not streaming:
            return out[7, : c1 - c0]            # trim any device-plan pad
        return _reduce_rows(out[7], kmin, n_slices=b - a,
                            slice_cells=slice_cells, n_v=n_v, n_s=n_s,
                            n_steps=n_steps, n_bins=int(n_bins))

    host_bytes = 0
    n_computed = 0

    def _fetch(out) -> Dict[str, np.ndarray]:
        """Copy one launch's payload to the host (the sync): the only
        device-to-host transfer of the campaign, which ``host_bytes``
        meters."""
        nonlocal host_bytes
        if streaming:
            wer, hist = (x.cpu().numpy() for x in out)
            host_bytes += wer.nbytes + hist.nbytes
            return {"wer": wer, "hist": hist}
        row7 = out.cpu().numpy()
        host_bytes += row7.nbytes
        return {"row7": row7}

    def _payload_ok(hit, a: int, b: int) -> bool:
        if hit is None:
            return False
        if streaming:
            return ("wer" in hit and "hist" in hit
                    and hit["wer"].shape == (b - a, n_v, n_p)
                    and hit["hist"].shape == (b - a, n_v, int(n_bins)))
        c0, c1 = span_cols(a, b)
        return "row7" in hit and hit["row7"].shape == (c1 - c0,)

    def _store_slice(a: int, b: int, payload) -> None:
        _cache.store_arrays(
            _slice_key(key, a, b, chunk, horizon, skind), payload,
            header={"campaign": key, "span": [int(a), int(b)],
                    "kind": skind},
            cache_dir=cache_dir)

    def _compute(a: int, b: int, out=None) -> Dict[str, np.ndarray]:
        """Dispatch (unless already in flight) and fetch one launch, with
        the retry ladder; a donated launch may have consumed the packed
        block by then, and the block is packed again."""
        nonlocal state, seeds, sigma, budget, lane_params, n_computed
        nonlocal consumed
        attempt = 0
        while True:
            try:
                if out is None:
                    if consumed:
                        state, seeds, sigma, budget, lane_params, _ = (
                            _pack_inputs())
                        if single_variation:
                            state, seeds, sigma, budget, lane_params = (
                                _bucket_pad(state, seeds, sigma, budget,
                                            lane_params))
                        consumed = False
                    out = dispatch(a, b)
                payload = _fetch(out)
                n_computed += 1
                return payload
            except Exception:
                out = None
                if attempt >= max_retries:
                    raise
                time.sleep(retry_backoff_s * (2.0 ** attempt))
                attempt += 1

    t0 = time.perf_counter()
    payloads: List[Optional[Dict[str, np.ndarray]]] = [None] * len(launches)
    n_resumed = 0
    whole = None

    if not multi:
        # enqueue every launch before the first copy to the host (the first
        # sync); checkpointed launches restore their payload instead, and a
        # failed dispatch is left to the fetch loop's retries
        outs: List[Optional[object]] = [None] * len(launches)
        for i, (a, b) in enumerate(launches):
            if ckpt:
                hit = _cache.load_arrays(
                    _slice_key(key, a, b, chunk, horizon, skind), cache_dir)
                if _payload_ok(hit, a, b):
                    payloads[i] = hit
                    n_resumed += 1
                    continue
            try:
                outs[i] = dispatch(a, b)
            except Exception:                # retried in the fetch loop
                outs[i] = None
        for i, (a, b) in enumerate(launches):
            if payloads[i] is not None:
                continue
            payloads[i] = _compute(a, b, out=outs[i])
            outs[i] = None
            if ckpt:
                _store_slice(a, b, payloads[i])
            if on_slice_complete is not None:
                on_slice_complete(i, len(launches))
    else:
        owner = f"proc{mesh.process_index}"
        skeys = [_slice_key(key, a, b, chunk, horizon, skind)
                 for a, b in launches]

        def _claim_and_run(i: int) -> None:
            # holding the claim, look for the whole-campaign entry again: a
            # peer that assembled retires the slice checkpoints only after
            # storing it, so a vanished slice is covered here and no launch
            # is integrated twice (absent a TTL steal)
            nonlocal whole
            whole = _load_whole()
            if whole is not None:
                _cache.release_claim(skeys[i], cache_dir)
                return
            a, b = launches[i]
            try:
                payload = _compute(a, b)
            except Exception:
                _cache.release_claim(skeys[i], cache_dir)
                raise
            _store_slice(a, b, payload)
            _cache.release_claim(skeys[i], cache_dir)
            payloads[i] = payload
            if on_slice_complete is not None:
                on_slice_complete(i, len(launches))

        # pass A: each process walks the launch ring from its own offset,
        # claiming what no peer has started, so P processes first touch
        # disjoint arcs of L launches and split them ~L / P each
        start = (len(launches) * mesh.process_index) // mesh.process_count
        for j in range(len(launches)):
            if whole is not None:
                break
            i = (start + j) % len(launches)
            a, b = launches[i]
            hit = _cache.load_arrays(skeys[i], cache_dir)
            if _payload_ok(hit, a, b):
                payloads[i] = hit
                n_resumed += 1
            elif _cache.try_claim(skeys[i], cache_dir, owner=owner):
                _claim_and_run(i)

        # pass B: poll the store for peers' slices, steal claims older than
        # the TTL (a dead peer), and adopt a peer's whole-campaign entry if
        # it assembled and retired the slices first
        deadline = time.time() + max(10.0 * mesh.claim_ttl_s, 30.0)
        while whole is None and any(pl is None for pl in payloads):
            whole = _load_whole()
            if whole is not None:
                break
            for i, (a, b) in enumerate(launches):
                if whole is not None or payloads[i] is not None:
                    continue
                hit = _cache.load_arrays(skeys[i], cache_dir)
                if _payload_ok(hit, a, b):
                    payloads[i] = hit
                    n_resumed += 1
                elif _cache.claim_age_s(skeys[i], cache_dir) is None:
                    if _cache.try_claim(skeys[i], cache_dir, owner=owner):
                        _claim_and_run(i)
                elif _cache.steal_claim(skeys[i], mesh.claim_ttl_s,
                                        cache_dir, owner=owner):
                    _claim_and_run(i)
            if whole is None and any(pl is None for pl in payloads):
                if time.time() > deadline:
                    raise RuntimeError(
                        f"campaign {key[:12]}: timed out waiting on peer "
                        f"slices (ttl {mesh.claim_ttl_s}s)")
                time.sleep(mesh.poll_s)
    elapsed = time.perf_counter() - t0

    if whole is not None:
        # a peer assembled first: adopt its stored entry as it is
        common = dict(elapsed_s=elapsed, from_cache=True,
                      n_launches=len(launches), n_resumed=n_resumed,
                      host_bytes=host_bytes, n_computed=n_computed)
        if streaming:
            return _reduced_result(whole["wer"], whole["hist"], **common)
        return CampaignResult(grid=grid, backend=backend,
                              crossing_time=whole, **common)

    def _retire_slices() -> None:
        if ckpt:
            for a, b in launches:
                _cache.drop_arrays(
                    _slice_key(key, a, b, chunk, horizon, skind), cache_dir)

    if streaming:
        wer_cat = np.concatenate([pl["wer"] for pl in payloads])
        hist_cat = np.concatenate([pl["hist"] for pl in payloads])
        if spec is not None:
            wer_cat = wer_cat.reshape(n_c, n_t, n_v, n_p)
            hist_cat = hist_cat.reshape(n_c, n_t, n_v, int(n_bins))
        if use_cache:
            _cache.store_arrays(
                red_key, {"wer": wer_cat, "hist": hist_cat},
                header={"campaign": key, "kind": "reduced",
                        "n_bins": int(n_bins), "backend": backend},
                cache_dir=cache_dir)
        _retire_slices()
        return _reduced_result(wer_cat, hist_cat, elapsed_s=elapsed,
                               n_launches=len(launches),
                               n_resumed=n_resumed, host_bytes=host_bytes,
                               n_computed=n_computed)

    # clip the rounded-up horizon's sentinel back to the grid's, in float64
    # before the dt multiply (in float32 n_steps*dt rounds below the f64
    # horizon and never-crossed lanes would count as switched)
    row7 = np.minimum(
        np.concatenate([pl["row7"] for pl in payloads]).astype(np.float64),
        float(n_steps))
    crossing = np.empty(expect_shape)
    for si, (lo, hi) in enumerate(spans):
        plane = row7[lo:hi].reshape(n_v, n_s) * grid.dt
        if spec is None:
            crossing[si] = plane
        else:
            crossing[si // n_t, si % n_t] = plane
    if use_cache:
        _cache.store(key, crossing,
                     header={"params": dataclasses.asdict(p),
                             "grid": dataclasses.asdict(grid),
                             "backend": backend},
                     cache_dir=cache_dir)
    _retire_slices()
    return CampaignResult(grid=grid, backend=backend, crossing_time=crossing,
                          elapsed_s=elapsed, n_launches=len(launches),
                          n_resumed=n_resumed, host_bytes=host_bytes,
                          n_computed=n_computed)
