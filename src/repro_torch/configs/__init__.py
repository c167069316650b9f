"""Architecture configurations of the port (``repro.configs``' layout):

  base        — ArchConfig / AttnConfig, MoEConfig / SSMConfig as plain
                data, with the reference's parameter counts
  <arch>      — the ten archs of the reference, one file each (qwen2_0_5b
                is the dense decoder the model-level analog study runs)
  registry    — ``ARCHS``, ``get_arch``, ``smoke_config`` and
                ``TRAIN_MICROBATCHES``
"""
