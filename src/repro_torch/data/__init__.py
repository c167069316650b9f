"""Training data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, batch_at,  # noqa: F401
                                       make_pipeline)
