"""Meshes of the port (``repro.launch.mesh``): model meshes and the
campaign mesh.

Model meshes are ``torch.distributed.device_mesh.DeviceMesh``es with
dimension names ("data", "model"), or ("pod", "data", "model"), over the
ranks of the initialized process group, rank-major in row order (the
reference's ``jax.make_mesh``): ``make_local_mesh(model)`` takes every
rank, ``make_production_mesh`` the reference's (16, 16) or (2, 16, 16)
pod mesh and raises unless the world has 256 (512) ranks;
``production_mesh_shape`` gives that mesh's ``MeshShape`` (names and
sizes, no devices) for plans on any host.  ``axis_sizes`` / ``data_axes``
read either kind.  The device type is "cuda" when the card is there, else
"cpu"; ranks of a gloo group may share one card.

A ``CampaignMesh`` describes one Monte-Carlo campaign's topology: a flat
cells axis over ``n_devices`` devices of this process, and
``process_count`` processes that split whole launches between them.
Processes never use a collective: they meet only in the content-addressed
campaign store (``campaign.cache`` claims and slice checkpoints), so a
mesh of processes needs nothing but a shared cache directory, and two
processes may share one GPU.

``build_campaign_mesh`` takes the process index and count from
``torch.distributed`` when a process group is initialized, else from the
``RANK`` / ``WORLD_SIZE`` environment variables, else 0 / 1; the device
count from the device list the caller passes, else
``torch.cuda.device_count()``.

The reference's ``host_device_flag`` (an XLA flag that splits one host CPU
into ``n`` devices) has no torch counterpart: torch has one CPU device.
The port's tests name one device several times instead
(``devices=["cpu"] * n``), which the engine runs as ``n`` shards.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.axis_names) == len(self.shape), self


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes that act as data parallel (pod folded into data)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The pod mesh: (data 16, model 16); multi-pod adds a leading pod
    axis of 2 for cross-pod data parallelism."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_mesh(shape: MeshShape, device_type: Optional[str]):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a model mesh spans the ranks of a process "
                           "group: call torch.distributed."
                           "init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape.shape) != world:
        raise ValueError(f"mesh {dict(zip(shape.axis_names, shape.shape))} "
                         f"needs {math.prod(shape.shape)} ranks; the world "
                         f"has {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape.shape,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The pod mesh (``production_mesh_shape``) over the world's ranks;
    raises unless the world has 256 (multi-pod 512) ranks."""
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod),
                        device_type)


def make_local_mesh(model: int = 1, device_type: Optional[str] = None):
    """A (data, model) mesh over every rank of the world, ``model`` ranks
    on the model axis."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axis {model}")
    return _device_mesh(MeshShape(("data", "model"), (n // model, model)),
                        device_type)


@dataclasses.dataclass(frozen=True)
class CampaignMesh:
    """Topology of one multi-device / multi-process campaign run.

    ``n_devices`` devices of this process share each launch's cells
    plane; ``process_index`` / ``process_count`` split whole launches
    across processes, which dedupe and exchange results through the store.
    ``claim_ttl_s`` bounds how long a process waits on a peer's claimed
    launch before presuming the peer dead and stealing the work;
    ``poll_s`` is the store's poll interval.
    """

    n_devices: int
    process_index: int = 0
    process_count: int = 1
    claim_ttl_s: float = 60.0
    poll_s: float = 0.05

    def __post_init__(self):
        assert self.n_devices >= 1, self.n_devices
        assert self.process_count >= 1, self.process_count
        assert 0 <= self.process_index < self.process_count, (
            self.process_index, self.process_count)
        assert self.claim_ttl_s > 0 and self.poll_s > 0


def _process_topology() -> tuple:
    """(index, count) of this process: ``torch.distributed`` when a group
    is initialized, else ``RANK`` / ``WORLD_SIZE``, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def build_campaign_mesh(
    devices: Union[None, int, Sequence] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    *,
    elastic_from: Optional[int] = None,
    claim_ttl_s: float = 60.0,
    poll_s: float = 0.05,
) -> CampaignMesh:
    """The campaign mesh of this process.

    ``devices`` is a device list (its length is the device count), an int
    (clamped to the visible CUDA devices) or None (every visible CUDA
    device; 1 without one).  ``elastic_from=N`` marks the resume of a
    campaign checkpointed on ``N`` devices: the count then goes through
    ``runtime.elastic.plan_campaign_devices``.  Slice checkpoints do not
    depend on the device count, so the resume is bit-identical either way.
    """
    import torch

    pi, pc = _process_topology()
    pi = pi if process_index is None else int(process_index)
    pc = pc if process_count is None else int(process_count)
    visible = max(1, torch.cuda.device_count())
    if devices is None:
        n = visible
    elif isinstance(devices, int):
        n = max(1, min(int(devices), visible))
    else:
        n = len(devices)
    if elastic_from is not None:
        from repro_torch.runtime.elastic import plan_campaign_devices

        n = plan_campaign_devices(n, old_devices=int(elastic_from)).mesh_shape[0]
    return CampaignMesh(n_devices=n, process_index=pi, process_count=pc,
                        claim_ttl_s=claim_ttl_s, poll_s=poll_s)
