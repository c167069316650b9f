"""Circuit-level behavioral models, PyTorch port of ``repro.circuit``:
  bitline   — RC transients of precharge/discharge through device conductances
  senseamp  — latch-type sense amplifier: delay vs differential, references
  subarray  — rows x cols 1T1J array: read / write / multi-row logic timing
"""
