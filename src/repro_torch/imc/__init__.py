"""Hierarchical in-memory-computing architecture model, PyTorch port of
``repro.imc`` (the main path of the paper):

  cpu_model    — ARM Cortex-A72 analytical baseline (the port's own copy)
  workloads    — the paper's six kernels as op traces (the port's own copy)
  write_margin — WER-targeted write-pulse sizing via the campaign engine
  write_path   — write-verify retry scheduler over thermal LLG transients
  hierarchy    — L1/L2/main-memory subarray organization
  evaluate     — system-level latency/energy vs the CPU baseline (Fig. 4)
"""
from repro_torch.imc.cpu_model import CORTEX_A72, CPUModel  # noqa: F401
from repro_torch.imc.workloads import WORKLOADS, Workload  # noqa: F401
