"""Device cost model: price every serving token in AFMTJ / MTJ / CPU time
(port of ``repro.imc.cost_model``).

The serving subsystem (DESIGN.md §11) runs on a simulated device clock: an
engine step reports what it computed (weight MACs, KV-cache element reads
and writes — ``StepCounts``) and a ``DeviceCostModel`` turns those counts
into seconds and joules on one technology:

* ``afmtj`` / ``mtj`` — per-unit prices from the measured IMC hierarchy
  (``imc.hierarchy.build_hierarchy`` -> MM-level ``SubarrayTimings``) on
  ``imc.mapping``'s crossbar mapping: weight GEMVs in crossbar mode (one
  XBAR x XBAR tile per ``t_read + ADC_T``), KV appends as row-serial
  writes (``t_write`` per XBAR-wide row across the parallel arrays).  The
  measured ``wer_target`` / ``write_percentile`` / ``read_percentile`` /
  ``offset_sigma`` knobs go to ``build_hierarchy`` as they are; a
  ``RefreshPolicy`` charges the scrub duty cycle, and a ``FaultSpec`` /
  ``RepairPolicy`` the hard-fault yield and cell overhead.
* ``cpu`` — the A72 baseline, each term at its own roofline bottleneck.

A decode token's cost is affine in its context position, so every model
also gives ``token_prices``: the ``(t_tok, t_pos)`` coefficients the
event-driven simulator (``launch.simulate``) integrates in closed form.

The counting half is pure Python; only ``imc_cost_model`` builds the
hierarchy (the device write solve on ``device``, CUDA by default).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional, Sequence

if TYPE_CHECKING:  # pragma: no cover - the hierarchy build is lazy
    from repro_torch.configs.base import ArchConfig
    from repro_torch.imc.faults import FaultSpec, RepairPolicy
    from repro_torch.imc.read_path import RefreshPolicy

TECHNOLOGIES = ("afmtj", "mtj", "cpu")


# --------------------------------------------------------------------------
# op counts: what one engine step computed (technology-independent)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenCounts:
    """Per-token op counts of one architecture (its serving signature).

    ``mac_weights``: weight MACs per token = active parameters (every active
    param multiplies the token's activation once — the weight-stationary
    GEMV the crossbar performs natively).  ``kv_elems``: KV-cache elements
    appended per token (2 x n_kv_heads x d_head per attention layer); each
    *prior* token's KV entry is read back once per generated token
    (causal attention), which is the position-linear term.
    """

    mac_weights: float
    kv_elems: float


@dataclasses.dataclass(frozen=True)
class StepCounts:
    """Op counts of one engine step (prefill wave or decode step)."""

    tokens: int              # tokens produced (live slots)
    mac_weights: float       # weight MACs executed
    kv_write_elems: float    # KV elements appended
    kv_read_elems: float     # KV elements read (attention over history)

    def __add__(self, o: "StepCounts") -> "StepCounts":
        return StepCounts(self.tokens + o.tokens,
                          self.mac_weights + o.mac_weights,
                          self.kv_write_elems + o.kv_write_elems,
                          self.kv_read_elems + o.kv_read_elems)


ZERO_COUNTS = StepCounts(0, 0.0, 0.0, 0.0)


def per_token_counts(cfg: "ArchConfig") -> TokenCounts:
    """Serving signature of an architecture.

    SSM mixers keep constant state (no growing KV); their state update is
    folded into the weight-MAC term via ``active_param_count`` — the model
    deliberately charges no position-linear cost for them, which is exactly
    the long-context argument for those architectures (DESIGN.md §3).
    Cross-attention KV (encdec) is static per request and also not grown.
    """
    reps = cfg.n_pattern_repeats
    attn_layers = sum(reps for mixer, _ in cfg.pattern
                      if mixer.startswith("attn"))
    kv = 2.0 * cfg.n_kv_heads * cfg.d_head * attn_layers
    return TokenCounts(mac_weights=float(cfg.active_param_count()),
                       kv_elems=float(kv))


def prefill_step_counts(tc: TokenCounts,
                        hist_lens: Sequence[int]) -> StepCounts:
    """One recompute-on-join prefill wave over the live slots' histories.

    Every history token runs the full weight GEMV and writes its KV entry;
    token ``i`` of a length-``L`` history attends to its ``i`` predecessors
    (the ``L*(L-1)/2`` triangle).  The wave's output token per slot is the
    argmax of the last position — it costs nothing extra here; its own
    forward is the next step.
    """
    toks = sum(int(h) for h in hist_lens)
    tri = sum(int(h) * (int(h) - 1) / 2.0 for h in hist_lens)
    return StepCounts(tokens=len(list(hist_lens)),
                      mac_weights=tc.mac_weights * toks,
                      kv_write_elems=tc.kv_elems * toks,
                      kv_read_elems=tc.kv_elems * tri)


def decode_step_counts(tc: TokenCounts,
                       positions: Sequence[int]) -> StepCounts:
    """One decode step: each live slot forwards one token whose attention
    reads the slot's current history length (``positions``) of KV entries."""
    live = len(list(positions))
    pos_sum = float(sum(int(p) for p in positions))
    return StepCounts(tokens=live,
                      mac_weights=tc.mac_weights * live,
                      kv_write_elems=tc.kv_elems * live,
                      kv_read_elems=tc.kv_elems * pos_sum)


# --------------------------------------------------------------------------
# the cost model proper
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepCost:
    t: float                 # simulated seconds
    e: float                 # joules


@dataclasses.dataclass(frozen=True)
class TokenPrices:
    """Affine per-token pricing for one (technology, architecture) pair.

    A decode token at context position ``p`` costs ``t_tok + t_pos * p``
    seconds (``e_tok + e_pos * p`` joules); a prefill over a length-``L``
    history costs ``L * t_tok + t_pos * L*(L-1)/2``.  These are exactly
    ``step_cost`` of the counting helpers above — the closed forms the
    event-driven simulator integrates per decode segment.
    """

    technology: str
    t_tok: float
    t_pos: float
    e_tok: float
    e_pos: float

    def decode_token(self, position: int) -> StepCost:
        return StepCost(self.t_tok + self.t_pos * position,
                        self.e_tok + self.e_pos * position)

    def prefill(self, hist_len: int) -> StepCost:
        tri = hist_len * (hist_len - 1) / 2.0
        return StepCost(self.t_tok * hist_len + self.t_pos * tri,
                        self.e_tok * hist_len + self.e_pos * tri)


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    """Per-unit op prices for one technology (architecture-independent).

    ``step_cost`` prices an engine step's measured op counts;
    ``token_prices`` folds an architecture's ``TokenCounts`` into the
    affine per-token coefficients.  ``e_standing_rate`` is a standing
    power draw (refresh/scrub energy) charged per simulated second.
    """

    kind: str
    t_mac: float
    e_mac: float
    t_kv_write: float
    e_kv_write: float
    t_kv_read: float
    e_kv_read: float
    e_standing_rate: float = 0.0        # [W] scrub power, charged per second
    # provenance (reporting only): the hierarchy write-stage numbers behind
    # the prices, mirroring SystemResult's write provenance fields
    t_write_op: float = 0.0
    write_attempts: float = 1.0
    refresh_interval: float = math.inf
    array_yield: float = 1.0            # P(array usable) under fault/repair

    def step_cost(self, c: StepCounts) -> StepCost:
        t = (c.mac_weights * self.t_mac
             + c.kv_write_elems * self.t_kv_write
             + c.kv_read_elems * self.t_kv_read)
        e = (c.mac_weights * self.e_mac
             + c.kv_write_elems * self.e_kv_write
             + c.kv_read_elems * self.e_kv_read
             + t * self.e_standing_rate)
        return StepCost(t, e)

    def token_prices(self, tc: TokenCounts) -> TokenPrices:
        one = self.step_cost(StepCounts(1, tc.mac_weights, tc.kv_elems, 0.0))
        per_pos = self.step_cost(StepCounts(0, 0.0, 0.0, tc.kv_elems))
        return TokenPrices(self.kind, one.t, per_pos.t, one.e, per_pos.e)


def cpu_cost_model(cpu=None) -> DeviceCostModel:
    """A72 decode-GEMV pricing: each term at its own roofline bottleneck.

    Weights stream 1 B/MAC (int8) from DRAM vs SIMD MAC issue; KV entries
    stream 1 B/element.  Energy: DRAM line energy per byte + per-MAC core
    energy — the constants of ``imc.mapping.map_arch_decode``.
    """
    from repro_torch.imc.cpu_model import CORTEX_A72

    cpu = cpu or CORTEX_A72
    t_byte = 1.0 / cpu.bw_dram
    t_mac_compute = 0.125 / (cpu.ipc * cpu.freq_hz)   # 16-lane SIMD int8
    e_byte = cpu.e_dram_line / cpu.line_bytes
    e_mac = 0.02e-12
    return DeviceCostModel(
        kind="cpu",
        t_mac=max(t_byte, t_mac_compute), e_mac=e_byte + e_mac,
        t_kv_write=t_byte, e_kv_write=e_byte,
        t_kv_read=max(t_byte, t_mac_compute), e_kv_read=e_byte + e_mac,
    )


def imc_cost_model(
    kind: str,
    v_write: float = 1.0,
    wer_target: Optional[float] = None,
    write_percentile: Optional[float] = None,
    read_percentile: Optional[float] = None,
    offset_sigma: float = 0.0,
    refresh: Optional["RefreshPolicy"] = None,
    resident_bytes: Optional[float] = None,
    faults: Optional["FaultSpec"] = None,
    repair: Optional["RepairPolicy"] = None,
    device=None,
) -> DeviceCostModel:
    """AFMTJ/MTJ crossbar pricing from the measured hierarchy timings.

    Weight MACs run in crossbar mode: an XBAR x XBAR tile GEMV costs one
    analog read + ADC conversion, with activation write-back pipelined at
    the 10% shadow (``imc.mapping``'s decode model); 8-bit weights occupy
    ``CELLS_PER_WEIGHT_8B`` cells.  KV appends are row-serial writes — one
    XBAR-wide row per ``t_write`` across ``IMC_PARALLEL_ARRAYS`` — which is
    where MTJ's nanosecond writes meet every generated token's KV entry and
    AFMTJ's picosecond writes hide.  KV reads are crossbar attention MACs,
    priced like weight MACs.

    ``refresh`` (+ ``resident_bytes``, the programmed footprint) charges a
    measured scrub policy (DESIGN.md §10): every op is stretched by the
    scrub duty cycle and the scrub pass energy becomes a standing rate.

    ``faults`` (+ optional ``repair``) charges the hard-defect model
    (DESIGN.md §13) the same way: arrays whose defects exceed the repair
    capacity are fused out, so effective parallelism shrinks by the array
    yield (latency x overhead/yield) and every op pays the spare-line/ECC
    cell overhead in area->energy.  Defaults off keep nominal bit-for-bit.
    The hierarchy's device solves run on ``device`` (None = CUDA).
    """
    from repro_torch.imc.hierarchy import build_hierarchy
    from repro_torch.imc.mapping import (ADC_E_PER_COL, ADC_T,
                                         CELLS_PER_WEIGHT_8B,
                                         IMC_PARALLEL_ARRAYS, XBAR,
                                         fault_cost_factors)

    hier = build_hierarchy(kind, v_write=v_write, wer_target=wer_target,
                           write_percentile=write_percentile,
                           read_percentile=read_percentile,
                           offset_sigma=offset_sigma, device=device)
    tm = hier.levels["MM"].timings
    cells = float(CELLS_PER_WEIGHT_8B)
    par = float(XBAR * IMC_PARALLEL_ARRAYS)

    # crossbar-mode MAC: tiles = macs*cells/XBAR^2, waves = tiles/PARALLEL
    t_mac = cells * (tm.t_read + ADC_T + 0.1 * tm.t_write) / (XBAR * par)
    e_mac = (cells * tm.e_read_bit
             + cells / XBAR * ADC_E_PER_COL
             + cells / XBAR * tm.e_write_bit * 0.02)
    # row-serial KV append: 8 cells/element, XBAR*PARALLEL cells per t_write
    t_kv_write = cells * tm.t_write / par
    e_kv_write = cells * tm.e_write_bit
    # crossbar attention MAC over the KV arrays
    t_kv_read = cells * (tm.t_read + ADC_T) / (XBAR * par)
    e_kv_read = cells * tm.e_read_bit + cells / XBAR * ADC_E_PER_COL

    duty_stretch, e_rate, interval = 1.0, 0.0, math.inf
    if refresh is not None and math.isfinite(refresh.interval):
        if resident_bytes is None:
            raise ValueError("refresh pricing needs resident_bytes "
                             "(the programmed footprint the scrub walks)")
        interval = refresh.interval
        rows_per_array = resident_bytes * 8.0 / par
        t_pass = rows_per_array * (tm.t_read + tm.t_write)
        duty = min(t_pass / interval, 0.95)
        duty_stretch = 1.0 / (1.0 - duty)
        e_pass = resident_bytes * 8.0 * (tm.e_read_bit + tm.e_write_bit)
        e_rate = e_pass / interval

    array_yield, cell_ovh, fault_stretch = fault_cost_factors(faults, repair)

    return DeviceCostModel(
        kind=kind,
        t_mac=t_mac * duty_stretch * fault_stretch, e_mac=e_mac * cell_ovh,
        t_kv_write=t_kv_write * duty_stretch * fault_stretch,
        e_kv_write=e_kv_write * cell_ovh,
        t_kv_read=t_kv_read * duty_stretch * fault_stretch,
        e_kv_read=e_kv_read * cell_ovh,
        e_standing_rate=e_rate,
        t_write_op=tm.t_write, write_attempts=tm.write_attempts,
        refresh_interval=interval, array_yield=array_yield,
    )


def device_cost_model(kind: str, **kw) -> DeviceCostModel:
    """One entry point over the three technologies.

    ``kind`` in ``TECHNOLOGIES``; keyword knobs are forwarded to
    ``imc_cost_model`` (ignored for ``cpu``, which takes only ``cpu=``;
    ``device=`` places the hierarchy's device solves).
    """
    if kind == "cpu":
        return cpu_cost_model(cpu=kw.get("cpu"))
    if kind not in ("afmtj", "mtj"):
        raise ValueError(f"unknown technology {kind!r}; "
                         f"choose from {TECHNOLOGIES}")
    kw.pop("cpu", None)
    return imc_cost_model(kind, **kw)
