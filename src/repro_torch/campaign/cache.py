"""On-disk campaign result cache of the port (content-addressed npz).

Port of ``repro.campaign.cache`` (generic store + campaign keys).  The
port's entries never mix with the reference's: its keys carry a port and
backend tag (a CUDA-kernel result and a CPU-plain result differ in the last
float32 bits), and its default directory is its own,
``$REPRO_TORCH_CAMPAIGN_CACHE`` or ``~/.cache/repro-torch-campaigns``.
Writes are atomic (tmp + rename).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.core.params import DeviceParams

# bump when the kernel's noise stream or integration scheme changes.
# v2: grids carry an optional process-variation spec (``CampaignGrid.
# variation``, keyed through the grid), and variation results store a
# (corner x T x V x S) tensor; the hit check in ``engine.run_campaign``
# tests that full shape.
KERNEL_VERSION = 2
CELLS_LAYOUT = "fused-CT/bucket-pow2"
PORT_TAG = "repro_torch"


def default_cache_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_CAMPAIGN_CACHE")
    if env:
        return Path(env)
    return Path(os.path.expanduser("~")) / ".cache" / "repro-torch-campaigns"


def content_key(payload: dict) -> str:
    """sha256 content key of a json-able payload (sorted keys)."""
    blob = json.dumps(payload, sort_keys=True, default=float)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def load_arrays(key: str, cache_dir: Optional[str] = None) -> Optional[dict]:
    """Named arrays of a cached entry (header excluded), or None on miss.
    Corrupt or torn files are misses, never errors."""
    path = Path(cache_dir or default_cache_dir()) / f"{key}.npz"
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files if k != "header"}
    except (OSError, KeyError, ValueError):
        return None


def store_arrays(key: str, arrays: dict, header: dict,
                 cache_dir: Optional[str] = None,
                 compress: bool = True) -> Path:
    """Atomically persist named arrays + a json header under ``key``.
    ``compress=False`` stores the arrays as they are: for large float
    planes (the programming cache's conductances) deflate costs far more
    time than it saves space."""
    assert "header" not in arrays, "reserved entry name"
    d = Path(cache_dir or default_cache_dir())
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"{key}.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    save = np.savez_compressed if compress else np.savez
    try:
        with os.fdopen(fd, "wb") as f:
            save(
                f, **arrays,
                header=np.frombuffer(
                    json.dumps(header, default=float).encode(), dtype=np.uint8))
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def campaign_key(p: DeviceParams, grid, backend: str) -> str:
    """Content hash of everything the crossing-time tensor depends on;
    ``backend`` names the path that computed it ("cuda-kernel" or
    "cpu-plain").  A nominal grid and a one-corner ``tt`` grid differ in
    their variation spec, so they never share an entry."""
    return content_key({
        "port": PORT_TAG,
        "v": KERNEL_VERSION,
        "layout": CELLS_LAYOUT,
        "params": dataclasses.asdict(p),
        "grid": dataclasses.asdict(grid),
        "backend": backend,
    })


def load(key: str, cache_dir: Optional[str] = None) -> Optional[np.ndarray]:
    """Cached crossing-time tensor ((n_T, n_V, n_S), or (n_C, n_T, n_V,
    n_S) for a variation grid), or None on miss."""
    arrays = load_arrays(key, cache_dir)
    if arrays is None or "crossing_time" not in arrays:
        return None
    return arrays["crossing_time"]


def store(key: str, crossing_time: np.ndarray, header: dict,
          cache_dir: Optional[str] = None) -> Path:
    return store_arrays(key, {"crossing_time": crossing_time}, header,
                        cache_dir)
