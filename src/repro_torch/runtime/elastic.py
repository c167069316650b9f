"""Elastic re-meshing: plan a smaller mesh after losing devices.

Port of ``repro.runtime.elastic`` (pure Python, the port's own copy).  The
plan keeps the ``model`` axis when it can (re-sharding tensor parallelism
moves every weight) and shrinks the ``data`` axis; the global batch is kept
by raising the microbatch count, so training dynamics do not change across
the resize.  ``plan_campaign_devices`` applies the same halving ladder to a
Monte-Carlo campaign's 1-D cells axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatch_scale: int          # multiply microbatches by this
    note: str


def plan_elastic_remesh(
    n_available: int,
    model_axis: int = 16,
    old_data_axis: int = 16,
    pods: int = 1,
) -> Optional[ElasticPlan]:
    """Largest (data' x model) mesh fitting ``n_available`` devices, data'
    halving down from ``old_data_axis``; None if not even data' = 1 fits."""
    if n_available >= pods * old_data_axis * model_axis:
        shape = ((pods, old_data_axis, model_axis) if pods > 1
                 else (old_data_axis, model_axis))
        names = ("pod", "data", "model") if pods > 1 else ("data", "model")
        return ElasticPlan(shape, names, 1, "full mesh healthy")
    data_axis = old_data_axis
    while data_axis > 1:
        data_axis //= 2
        if n_available >= data_axis * model_axis:
            scale = old_data_axis // data_axis
            return ElasticPlan(
                (data_axis, model_axis),
                ("data", "model"),
                scale,
                f"degraded: data {old_data_axis}->{data_axis}, "
                f"microbatches x{scale} preserves global batch",
            )
    return None


def plan_campaign_devices(n_available: int,
                          old_devices: int) -> ElasticPlan:
    """Elastic plan for a campaign checkpointed on ``old_devices`` devices
    and resumed on ``n_available``.

    Slice checkpoints are keyed by (campaign, span, chunk, horizon), never
    by device count, and every lane of a launch integrates alone, so any
    device count reassembles the same crossing rows bit for bit.  The plan
    keeps the per-launch device count on the halving ladder of
    ``plan_elastic_remesh`` (a campaign has no model axis);
    ``microbatch_scale`` is the stretch of each launch's wall time.
    """
    assert old_devices >= 1, old_devices
    if n_available >= old_devices:
        return ElasticPlan((old_devices,), ("cells",), 1, "full mesh healthy")
    plan = plan_elastic_remesh(n_available, model_axis=1,
                               old_data_axis=old_devices)
    if plan is None:                      # < 1 device: run serially
        return ElasticPlan((1,), ("cells",), old_devices,
                           f"degraded to 1 device, launches x{old_devices}")
    return ElasticPlan((plan.mesh_shape[0],), ("cells",),
                       plan.microbatch_scale, plan.note)
