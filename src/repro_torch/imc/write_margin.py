"""WER-margined write pulses — the campaign engine's IMC client.

Port of ``repro.imc.write_margin``: turn a write-error-rate target into a
pulse width by running one thermal Monte-Carlo campaign over a pulse ladder
(pulse width is post-processing of the first-crossing row) and taking the
smallest rung that meets the target at every temperature, and with
``variation`` at every process corner, asked for (DESIGN.md §9).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

from repro_torch.core.params import (AFMTJ_PARAMS, MTJ_PARAMS, DeviceParams,
                                     VariationSpec)

# Pulse ladders bracketing each device's thermal switching tail; rung
# spacing is the pulse-width quantization of the margin.
_LADDERS = {
    "afmtj": tuple(x * 1e-12 for x in (120, 160, 200, 250, 300, 400, 600)),
    "mtj": tuple(x * 1e-12 for x in (800, 1200, 1600, 2200, 3000, 4500, 6000)),
}
# Per-device campaign time steps (MTJ reversal is ~10x slower).
DEVICE_DT = {"afmtj": 0.1e-12, "mtj": 0.2e-12}


def params_for(kind: str) -> DeviceParams:
    if kind not in ("afmtj", "mtj"):
        raise ValueError(f"unknown device kind {kind!r}")
    return AFMTJ_PARAMS if kind == "afmtj" else MTJ_PARAMS


@functools.lru_cache(maxsize=None)
def wer_margined_pulse(
    kind: str,
    v_write: float = 1.0,
    wer_target: float = 1e-2,
    n_samples: int = 128,
    seed: int = 0,
    use_cache: bool = True,
    ladder: Optional[Tuple[float, ...]] = None,
    temperatures: Optional[Tuple[float, ...]] = None,
    variation: Optional[VariationSpec] = None,
    device=None,
) -> float:
    """Smallest ladder pulse [s] with WER <= ``wer_target`` at ``v_write``,
    at the worst (corner, temperature) cell: every temperature of
    ``temperatures`` (default: the device's nominal one) and every corner
    of ``variation`` — one fused campaign.  Raises ValueError when no rung
    meets the target."""
    from repro_torch.campaign.engine import run_campaign
    from repro_torch.campaign.grid import CampaignGrid

    p = params_for(kind)
    pulses = ladder or _LADDERS[kind]
    temps = (tuple(float(t) for t in temperatures) if temperatures
             else (p.temperature,))
    grid = CampaignGrid(voltages=(float(v_write),), pulse_widths=pulses,
                        temperatures=temps, n_samples=n_samples,
                        dt=DEVICE_DT[kind], seed=seed, variation=variation)
    res = run_campaign(p, grid, use_cache=use_cache, device=device)
    # corner_index=None: the worst corner at every pulse
    return max(res.pulse_for_wer(wer_target, t_index=ti, v_index=0,
                                 corner_index=None)
               for ti in range(len(temps)))
