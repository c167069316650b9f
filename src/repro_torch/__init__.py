"""PyTorch/CUDA port of the AFMTJ in-memory-computing reproduction.

Same layout and module names as the JAX package ``repro`` (the reference
it is held against), imports neither JAX nor ``repro``:

  core      — constants, DeviceParams, LLG right-hand side, integrators,
              TMR readout, single-junction write and voltage sweeps
              (``simulate_write``, ``write_sweep``)
  kernels   — counter-RNG noise, the plain PyTorch versions (``ref``) and
              the hand-written CUDA kernels: the LLG campaign kernel that
              replaces the Pallas TPU kernels, the single-junction write,
              and the analog MVM kernels
  configs   — the ten architecture configs of the reference
  campaign  — thermal Monte-Carlo campaign packing, engine and cache
  circuit   — bit-line, sense-amp and subarray timing models
  imc       — WER-margined pulses, write-verify, hierarchy, the Fig. 4
              system evaluation, the decode mapping and the analog
              accuracy stack
  models    — the dense decoder stack the model-level study runs

Entry points take ``device=None``, which means ``"cuda"``: without a CUDA
device they raise instead of running on the CPU.  Pass ``device="cpu"`` to
run the plain PyTorch versions of every kernel on the host.
"""
from repro_torch._device import resolve_device  # noqa: F401
