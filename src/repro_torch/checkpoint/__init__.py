"""Checkpointing (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer, ShardedCheckpointer)
