"""PyTorch/CUDA port of the AFMTJ in-memory-computing reproduction.

Same layout and module names as the JAX package ``repro`` (the reference
it is held against), imports neither JAX nor ``repro``:

  core      — constants, DeviceParams, LLG right-hand side, RK4, single
              junction write (``simulate_write``)
  kernels   — counter-RNG noise, the plain PyTorch LLG integrator
              (``ref.ref_llg_rk4``) and the hand-written CUDA kernel that
              replaces the Pallas TPU kernel (``llg_rk4.llg_rk4_kernel``)
  campaign  — thermal Monte-Carlo campaign packing, engine and cache
  circuit   — bit-line, sense-amp and subarray timing models
  imc       — WER-margined pulses, write-verify, hierarchy and the Fig. 4
              system evaluation

Entry points take ``device=None``, which means ``"cuda"``: without a CUDA
device they raise instead of running on the CPU.  Pass ``device="cpu"`` to
run the plain PyTorch versions of every kernel on the host.
"""
from repro_torch._device import resolve_device  # noqa: F401
