"""Opt-in collective tuning profiles (port of ``repro.runtime.xla_flags``,
DESIGN.md §14).

The reference packages XLA flags as named profiles that a driver merges
into a child process's ``XLA_FLAGS``.  The port has no XLA: its
collectives are ``torch.distributed``'s, tuned by environment variables
that NCCL and ``ProcessGroupNCCL`` read when a process group is created.
A profile here is the tuple of ``NAME=value`` settings that do what the
reference's flags do, where such a setting exists; ``flags_for`` joins
them with spaces and ``apply_profile`` merges them into an environment.
Like the reference, a profile is meant for the environment of a future
process: with ``env=None`` after this process has created its process
group the settings would not take effect, so ``apply_profile`` warns and
returns the environment unmerged.  A variable the environment already
sets keeps its value (the user's explicit setting wins).

``gpu-scaling``, flag by flag:

* ``--xla_gpu_enable_highest_priority_async_stream=true`` ->
  ``TORCH_NCCL_HIGH_PRIORITY=1`` (NCCL's streams at the highest
  priority, so collectives are not queued behind compute kernels);
* ``--xla_gpu_enable_latency_hiding_scheduler`` and
  ``--xla_gpu_enable_pipelined_{all_gather,reduce_scatter,all_reduce}``:
  no counterpart.  They reorder a compiled program's collectives around
  its compute; eager PyTorch issues each collective where the program
  calls it, and overlap is the program's own (``async_op=True``);
* ``--xla_gpu_{all_reduce,all_gather,reduce_scatter}_combine_threshold_
  bytes`` and ``--xla_gpu_enable_{all_gather,reduce_scatter}_combine_by_
  dim``: no counterpart.  XLA merges small collectives of one program
  into fewer large ones; NCCL runs the collectives it is given, and
  bucketing is a caller's choice (DDP's ``bucket_cap_mb`` argument);
* ``--xla_gpu_enable_while_loop_double_buffering``: no counterpart (an
  XLA loop transformation; the port's loops are Python).

``host-devices`` (``--xla_force_host_platform_device_count``, which splits
one host CPU into n devices) has no counterpart: torch has one CPU device.
The port names it n times instead (``devices=["cpu"] * n``), and
``flags_for`` / ``apply_profile`` raise a ``KeyError`` saying so.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

PROFILES: Dict[str, Tuple[str, ...]] = {
    "gpu-scaling": (
        "TORCH_NCCL_HIGH_PRIORITY=1",
    ),
}

NO_COUNTERPART = {
    "host-devices": "the XLA flag --xla_force_host_platform_device_count "
                    "splits one host CPU into n devices; torch has one CPU "
                    "device: name it n times (devices=['cpu'] * n)",
}


def flags_for(profile: str, **fmt) -> str:
    """The profile's ``NAME=value`` settings (space-joined), with
    ``{key}`` format fields substituted."""
    if profile in NO_COUNTERPART:
        raise KeyError(f"profile {profile!r} has no torch counterpart: "
                       f"{NO_COUNTERPART[profile]}")
    if profile not in PROFILES:
        raise KeyError(f"unknown profile {profile!r}; have "
                       f"{sorted(PROFILES)}")
    return " ".join(f.format(**fmt) for f in PROFILES[profile])


def process_group_initialized() -> bool:
    """Whether this process already created its process group (settings
    applied now would not reach it)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def apply_profile(profile: str, env: Optional[Dict[str, str]] = None,
                  **fmt) -> Dict[str, str]:
    """Merge a profile's settings into ``env`` and return it (a copy).

    ``env=None`` copies ``os.environ``: the common case of building a
    child process's environment.  A variable ``env`` already sets keeps
    its value.  With ``env=None`` after this process created its process
    group, warns and returns the environment unmerged."""
    settings = flags_for(profile, **fmt).split()
    if env is None:
        if process_group_initialized():
            warnings.warn(
                f"profile {profile!r} not applied: this process's process "
                "group already exists; start a child with this environment "
                "instead", RuntimeWarning, stacklevel=2)
            return dict(os.environ)
        env = dict(os.environ)
    else:
        env = dict(env)
    for setting in settings:
        name, value = setting.split("=", 1)
        env.setdefault(name, value)
    return env
