"""Core AFMTJ/MTJ compact device model, PyTorch port of ``repro.core``.

Layers:
  params      — physical constants + calibrated DeviceParams (Table II)
  llg         — dual-sublattice LLG right-hand side + state helpers
  integrator  — one RK4 step (the fixed-step scheme every path uses)
  tmr         — Julliere-type angular conductance / TMR readout
  device      — single-junction write with self-consistent STT drive
  montecarlo  — Brown's thermal-field sigma
"""
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams  # noqa: F401
