"""System-level evaluation: IMC hierarchy vs CPU baseline (paper Fig. 4).

Port of ``repro.imc.evaluate``.
Latency: the controller retires row-granular ops; logic and write-back
pipeline, so the stage time is max(logic, write) + 0.1 min(logic, write).
Energy: per-bit device energies + per-row-op peripheral energy.

Refresh (DESIGN.md §10): a ``RefreshPolicy`` (``imc.read_path``, from
measured retention and read-disturb budgets) makes the scrub controller a
steady-state bandwidth tax: every ``interval`` each resident data row is
read and rewritten.  ``evaluate_workload(..., refresh=...)`` charges that
duty cycle into ``t_imc`` / ``e_imc`` and reports it as ``t_refresh`` /
``e_refresh``.

Hard faults (DESIGN.md §13): a ``FaultSpec`` (with an optional
``RepairPolicy``) charges the repair-capacity model of
``imc.mapping.fault_cost_factors``: latency stretched by overhead / yield
(condemned arrays' work re-runs on survivors), energy by the spare-line /
ECC cell overhead, the yield reported as ``array_yield``.  With every
option off the numbers are the nominal Fig. 4 numbers, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:  # pragma: no cover - read_path imports the circuit stack
    from repro_torch.imc.faults import FaultSpec, RepairPolicy
    from repro_torch.imc.read_path import RefreshPolicy

from repro_torch.imc.cpu_model import CORTEX_A72, CPUModel
from repro_torch.imc.hierarchy import IMCHierarchy, build_hierarchy
from repro_torch.imc.workloads import WORKLOADS, Workload


@dataclasses.dataclass(frozen=True)
class SystemResult:
    workload: str
    t_cpu: float
    e_cpu: float
    t_imc: float
    e_imc: float
    # write-stage provenance: the per-row-op write time the stage model used
    # and the retry statistics behind it (1.0 / 0.0 for the closed form)
    t_write_op: float = 0.0
    write_attempts: float = 1.0
    write_residual_ber: float = 0.0
    # refresh provenance (0.0 / inf without a RefreshPolicy): the scrub
    # time and energy folded into t_imc / e_imc, and the policy's interval
    t_refresh: float = 0.0
    e_refresh: float = 0.0
    refresh_interval: float = math.inf
    # hard-fault provenance: the fraction of arrays the repair budget
    # salvages (1.0 without a FaultSpec)
    array_yield: float = 1.0

    @property
    def speedup(self) -> float:
        return self.t_cpu / self.t_imc

    @property
    def energy_saving(self) -> float:
        return self.e_cpu / self.e_imc


def evaluate_workload(w: Workload, hier: IMCHierarchy,
                      cpu: CPUModel = CORTEX_A72,
                      refresh: Optional["RefreshPolicy"] = None,
                      faults: Optional["FaultSpec"] = None,
                      repair: Optional["RepairPolicy"] = None
                      ) -> SystemResult:
    t_cpu, e_cpu = cpu.kernel_time_energy(
        w.n_elems, w.cpu_instrs_per_elem, w.cpu_simd_fraction,
        w.cpu_bytes_per_elem, w.footprint_bytes)

    level = hier.level_for_footprint(w.footprint_bytes)
    tm = level.timings
    elems_per_op = level.row_bits / w.bits_per_elem  # row-parallel elements

    n = w.n_elems / elems_per_op                     # row-op batches
    t_logic = n * (w.logic2 * tm.t_logic2 + w.logic3 * tm.t_logic3
                   + w.reads * tm.t_read)
    t_write = n * w.writes * tm.t_write
    # pipelined execution: logic (sense phase) overlaps write-back
    t_imc = max(t_logic, t_write) + min(t_logic, t_write) * 0.1

    # op counts are per element; each bit-serial op touches one bit-cell per
    # element; 3-row majority conducts through three cells
    e_cells = w.n_elems * (
        w.logic2 * tm.e_logic_bit
        + w.logic3 * tm.e_logic3_bit
        + w.writes * tm.e_write_bit
        + w.reads * tm.e_read_bit)
    n_row_ops = n * (w.logic2 + w.logic3 + w.writes + w.reads)
    e_imc = e_cells + n_row_ops * level.spec.e_periph_row_op

    # refresh: every interval the scrub reads and rewrites each resident
    # data row; it steals a duty fraction of row-op bandwidth (stretching
    # the workload by duty / (1 - duty)) and one read + write pass of the
    # footprint per interval
    t_refresh = e_refresh = 0.0
    interval = math.inf
    if refresh is not None and math.isfinite(refresh.interval):
        interval = refresh.interval
        data_rows = max(1.0, w.footprint_bytes * 8.0 / level.row_bits)
        duty = min(data_rows * (tm.t_read + tm.t_write) / interval, 0.95)
        t_refresh = t_imc * duty / (1.0 - duty)
        t_imc = t_imc + t_refresh
        bits = data_rows * level.row_bits
        e_pass = (bits * (tm.e_read_bit + tm.e_write_bit)
                  + 2.0 * data_rows * level.spec.e_periph_row_op)
        e_refresh = (t_imc / interval) * e_pass
        e_imc = e_imc + e_refresh

    # hard faults: condemned arrays' work re-runs on survivors (latency x
    # overhead / yield); spare lines and ECC cost energy on every access
    array_yield = 1.0
    if faults is not None:
        from repro_torch.imc.mapping import fault_cost_factors

        array_yield, cell_ovh, fault_stretch = fault_cost_factors(
            faults, repair)
        t_imc = t_imc * fault_stretch
        e_imc = e_imc * cell_ovh
    return SystemResult(w.name, t_cpu, e_cpu, t_imc, e_imc,
                        t_write_op=tm.t_write,
                        write_attempts=tm.write_attempts,
                        write_residual_ber=tm.write_residual_ber,
                        t_refresh=t_refresh, e_refresh=e_refresh,
                        refresh_interval=interval, array_yield=array_yield)


def evaluate_system(kind: str = "afmtj", v_write: float = 1.0,
                    wer_target: Optional[float] = None,
                    write_percentile: Optional[float] = None,
                    read_percentile: Optional[float] = None,
                    offset_sigma: float = 0.0,
                    refresh: Optional["RefreshPolicy"] = None,
                    faults: Optional["FaultSpec"] = None,
                    repair: Optional["RepairPolicy"] = None,
                    device=None) -> Dict[str, SystemResult]:
    """Fig. 4 over the paper's six workloads.  ``wer_target`` sizes write
    pulses from the thermal-tail campaign; ``write_percentile`` (e.g. 99.0)
    uses the measured write-verify row time at that percentile;
    ``read_percentile`` / ``offset_sigma`` do the same for the sense time
    (``imc.read_path``), ``refresh`` charges a measured scrub policy and
    ``faults`` / ``repair`` the hard-fault repair model.  All off keeps
    the nominal Fig. 4 numbers bit for bit."""
    hier = build_hierarchy(kind, v_write=v_write, wer_target=wer_target,
                           write_percentile=write_percentile,
                           read_percentile=read_percentile,
                           offset_sigma=offset_sigma, device=device)
    return {name: evaluate_workload(w, hier, refresh=refresh,
                                    faults=faults, repair=repair)
            for name, w in WORKLOADS.items()}


def summarize(results: Dict[str, SystemResult]):
    """Arithmetic-mean (speedup, energy_saving) across workloads."""
    sp = statistics.mean(r.speedup for r in results.values())
    es = statistics.mean(r.energy_saving for r in results.values())
    return sp, es


def summarize_geomean(results: Dict[str, SystemResult]):
    """Geometric-mean (speedup, energy_saving) across workloads."""
    sp = statistics.geometric_mean(r.speedup for r in results.values())
    es = statistics.geometric_mean(r.energy_saving for r in results.values())
    return sp, es
