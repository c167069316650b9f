"""Analog bit-line MAC with a signed ADC (port of
``repro.kernels.bitline_mac``).

Word lines drive read voltages V (batch, rows); each column's bit line sums
the cell currents I = V @ G; a signed symmetric mid-tread ADC quantizes the
column current over [-i_max, +i_max] with 2^(bits-1)-1 levels per side.

``bitline_mac_kernel`` is the wrapper of the CUDA kernel in
``csrc/analog_mac.cu`` (replaces the Pallas ``_mac_kernel``):

* a CPU tensor runs the plain PyTorch version ``ref.ref_bitline_mac``;
* a CUDA tensor launches the kernel on the current stream, or raises.
  Grids under one wave split K (``analog_mac.split_count``): the call then
  launches the mainloop and a second kernel, the reduce pass, that adds the
  partials in split order and applies the ADC.

``bitline_mac_kernel.launches`` counts mainloop launches,
``.reduce_launches`` reduce-pass launches and ``.launch_shapes`` mainloop
launches by (M, K, N) (``analog_mac`` module note); CPU calls count
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import analog_mac
from repro_torch.kernels.ref import ref_bitline_mac


def adc_quantize(i_bl: torch.Tensor, adc_bits: int, i_max) -> torch.Tensor:
    """Signed symmetric mid-tread ADC: clip ``i_bl / i_max`` to [-1, 1],
    quantize to 2^(bits-1)-1 levels per side (``adc_bits`` 0 = ideal).
    ``i_max`` is a scalar or a row broadcast over the columns.  The
    divisions take tensor divisors, so they are IEEE divisions on either
    device (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal); ``torch.round`` rounds half to even, like ``jnp.round``."""
    if adc_bits <= 0:
        return i_bl
    assert adc_bits >= 2, f"signed ADC needs >= 2 bits, got {adc_bits}"
    dev = i_bl.device
    half = torch.tensor(float(2 ** (adc_bits - 1) - 1), dtype=torch.float32,
                        device=dev)
    i_max = torch.as_tensor(i_max, dtype=torch.float32, device=dev)
    x = torch.clamp(i_bl / i_max, -1.0, 1.0)
    return torch.round(x * half) / half * i_max


def bitline_mac_kernel(v: torch.Tensor, g: torch.Tensor, adc_bits: int = 0,
                       i_max: float = 1.0) -> torch.Tensor:
    """(M, K) read voltages @ (K, N) conductances -> (M, N) float32 ADC
    output (signature of the reference's ``bitline_mac_pallas``)."""
    M, K, N = analog_mac.gemm_shapes("bitline_mac", v, g)
    assert adc_bits == 0 or adc_bits >= 2, adc_bits
    if v.is_cpu:
        return ref_bitline_mac(v, g, adc_bits, i_max)
    index = analog_mac.cuda_index("bitline_mac", v, g)
    v, g = analog_mac.f32(v), analog_mac.f32(g)
    out = torch.empty((M, N), dtype=torch.float32, device=v.device)
    if M and N:
        lib, splits, ws = analog_mac.plan("analog_mac", M, K, N, v)
        vec = N % 4 == 0 and analog_mac.aligned(g)
        analog_mac.launch("bitline_mac", lib.bitline_mac_launch, index,
                          v.data_ptr(), g.data_ptr(), out.data_ptr(),
                          analog_mac.ptr(ws), M, K, N, splits, int(vec),
                          int(adc_bits), float(i_max))
        analog_mac.count(bitline_mac_kernel, M, K, N, splits)
    return out


analog_mac.reset_counts(bitline_mac_kernel)
