"""Core AFMTJ/MTJ compact device model, PyTorch port of ``repro.core``.

Layers:
  params      — physical constants + calibrated DeviceParams (Table II)
  llg         — dual-sublattice LLG right-hand side + state helpers
  integrator  — RK4 step, fixed-step and adaptive step-doubling RK4
  tmr         — Julliere-type angular conductance / TMR readout
  device      — single-junction write with self-consistent STT drive
                (the write loop runs as a CUDA kernel on the card), voltage
                sweeps, read
  montecarlo  — Brown's thermal-field sigma, the write-error rate (one
                campaign launch) and its per-step scan baseline
"""
from repro_torch.core.params import AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams  # noqa: F401
from repro_torch.core.device import simulate_write, write_sweep, simulate_read  # noqa: F401
from repro_torch.core.llg import llg_rhs, neel_vector, initial_state  # noqa: F401
from repro_torch.core.tmr import conductance, resistance, tmr_ratio  # noqa: F401
