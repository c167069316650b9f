"""Sharding plans of the port: the campaign's cells plan.

Port of ``repro.launch.sharding.plan_cell_tiles``.  The model sharding
rules of the reference module (parameter, activation, batch and cache
shardings over a device mesh) are scale-out work the port has not taken
yet (ROADMAP A12c).
"""
from __future__ import annotations

from typing import Tuple


def plan_cell_tiles(tiles: int, n_dev: int) -> Tuple[int, int]:
    """Even tiles-per-device plan for the campaign's 1-D cells axis.

    Returns ``(tiles_per_dev, padded_tiles)``, ``padded_tiles`` the
    smallest multiple of ``n_dev`` >= ``tiles``.  The campaign engine pads
    a launch with budget-0 lanes up to ``padded_tiles`` instead of running
    it on fewer devices (``campaign.engine._device_plan``); the pad costs at
    most ``n_dev - 1`` frozen tiles, which leave on their first early-exit
    chunk.
    """
    assert tiles > 0 and n_dev > 0, (tiles, n_dev)
    per = -(-tiles // n_dev)
    return per, per * n_dev
