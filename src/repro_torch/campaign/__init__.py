"""Thermal Monte-Carlo campaign engine, PyTorch port of ``repro.campaign``.

  grid    — CampaignGrid axes + SoA packing (fused corner x temperature
            plane, power-of-two lane buckets, log horizon ladder)
  engine  — run_campaign / run_ensemble through the LLG kernel + surface
            reductions (process-corner axis), split launches with slice
            checkpoints and crash resume, the streaming on-device
            reduction, donated launches, device plans and multi-process
            campaigns (DESIGN.md §13, §14)
  cache   — content-addressed npz result cache of the port + lockless
            work claims
"""
from repro_torch.campaign.cache import campaign_key  # noqa: F401
from repro_torch.campaign.engine import (  # noqa: F401
    EARLY_EXIT_CHUNK,
    CampaignResult,
    EnsembleResult,
    brown_sigma,
    run_campaign,
    run_ensemble,
)
from repro_torch.campaign.grid import (  # noqa: F401
    HORIZON_RUNGS_PER_DECADE,
    CampaignGrid,
    bucket_cells,
    log_horizon_bucket,
    log_pulses,
    next_pow2,
    pack_campaign,
    pack_plane,
    pack_soa,
    pack_variation,
    tilt_draws,
)
