"""AdamW with global-norm clipping and the WSD schedule (port of
``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import wsd_schedule  # noqa: F401
