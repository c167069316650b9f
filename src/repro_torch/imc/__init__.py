"""Hierarchical in-memory-computing architecture model, PyTorch port of
``repro.imc`` (the main path of the paper):

  cpu_model    — ARM Cortex-A72 analytical baseline (the port's own copy)
  workloads    — the paper's six kernels as op traces (the port's own copy)
  write_margin — WER-targeted write-pulse sizing via the campaign engine
  write_path   — write-verify retry scheduler over thermal LLG transients,
                 per process corner
  read_path    — read-disturb / retention / sense-margin scenarios, measured
                 read timings and the derived refresh policy (DESIGN.md §10)
  hierarchy    — L1/L2/main-memory subarray organization
  evaluate     — system-level latency/energy vs the CPU baseline (Fig. 4)

The modules that reach the campaign engine and the kernels export lazily,
as in the reference.
"""
import importlib

from repro_torch.imc.cpu_model import CORTEX_A72, CPUModel  # noqa: F401
from repro_torch.imc.workloads import WORKLOADS, Workload  # noqa: F401

_LAZY_EXPORTS = {
    "hierarchy": ("IMCHierarchy", "build_hierarchy"),
    "evaluate": ("evaluate_system", "SystemResult"),
    "write_margin": ("wer_margined_pulse",),
    "write_path": ("WritePolicy", "ArrayWriteResult", "MeasuredWrite",
                   "write_verify", "write_verify_corners",
                   "measured_write_timings", "nominal_pulse"),
    "read_path": ("ReadDisturbResult", "DisturbModel", "RetentionResult",
                  "SenseYieldResult", "SizedRead", "MeasuredRead",
                  "RefreshPolicy", "read_disturb_campaign",
                  "fit_disturb_model", "accumulated_disturb",
                  "reads_between_refresh", "retention_campaign",
                  "retention_horizons", "sense_margin_yield",
                  "size_read_drive", "measured_read_timings",
                  "derive_refresh_policy"),
}


def __getattr__(name):
    for module, names in _LAZY_EXPORTS.items():
        if name in names:
            mod = importlib.import_module(f"repro_torch.imc.{module}")
            return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
