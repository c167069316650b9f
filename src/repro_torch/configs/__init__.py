"""Architecture configurations of the port (``repro.configs``' layout):

  base        — ArchConfig / AttnConfig, MoEConfig / SSMConfig as plain data
  qwen2_0_5b  — the dense decoder the model-level analog study runs
  registry    — ``get_arch`` / ``smoke_config`` over the archs the port runs
"""
