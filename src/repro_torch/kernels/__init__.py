"""Kernels of the port and their plain PyTorch versions.

  noise    — stateless counter-RNG (lowbias32 + Box-Muller), the uint32
             stream of ``repro.kernels.noise`` bit for bit
  ref      — ``ref_llg_rk4`` / ``ref_llg_write``: the plain PyTorch LLG
             campaign integrator and single-junction write, the kernels'
             CPU paths and their comparison targets on the card
  llg_rk4  — ``llg_rk4_kernel``: wrapper of the CUDA kernel
             ``csrc/llg_rk4.cu`` (replaces the Pallas ``_llg_kernel`` and
             ``_llg_thermal_kernel``)
  llg_write
           — ``llg_write_kernel``: wrapper of the single-junction write
             kernel ``csrc/llg_write.cu`` (the reference's write scan);
             both LLG sources share the RK4 step of ``csrc/llg_step.cuh``
  bitline_mac
           — wrapper of the bit-line MAC (B3), a float32 split-K mainloop
             in ``csrc/analog_mac.cu``
  fake_analog
           — wrapper of the fake-analog MVM (B5), the same mainloop fed by
             a producer warpgroup that replays the conductances, in
             ``csrc/fake_analog.cu``
  xnor_gemm
           — wrapper of the XNOR GEMM (B4), bf16 tensor cores in
             ``csrc/xnor_gemm.cu``
  adc_sizing
           — wrapper of the fake-analog operand sizing (the ADC full scale
             and decode gain into B5's aux plane, on the card), in
             ``csrc/adc_sizing.cu``
  analog_mac
           — ctypes bindings of the analog sources and their split-K rule
  ops      — public entry points and the (8, cells) SoA packing helpers
  build    — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
"""
