"""On-disk campaign result cache of the port (content-addressed npz).

Port of ``repro.campaign.cache``: the generic store, its stale-file sweeps,
the lockless work claims and the campaign keys.  The port's entries never
mix with the reference's: its keys carry a port and backend tag (a
CUDA-kernel result and a CPU-plain result differ in the last float32 bits),
and its default directory is its own, ``$REPRO_TORCH_CAMPAIGN_CACHE`` or
``~/.cache/repro-torch-campaigns``; claims are files of that directory named
after the port's keys.  Writes are atomic (tmp + rename), so concurrent
campaign processes never observe a torn file.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
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


def gc_stale_tmp(cache_dir: Optional[str] = None,
                 max_age_s: float = 86400.0) -> int:
    """Remove ``*.tmp`` files older than ``max_age_s`` seconds; returns how
    many.  A process killed inside ``store_arrays`` leaves its temporary
    file behind (the rename never ran, so no entry is torn); the age guard
    spares live writers of other processes, whose files are seconds old.
    Errors are ignored: a racing writer may rename or unlink first."""
    d = Path(cache_dir or default_cache_dir())
    if not d.is_dir():
        return 0
    cutoff = time.time() - max_age_s
    removed = 0
    for tmp in d.glob("*.tmp"):
        try:
            if tmp.stat().st_mtime <= cutoff:
                tmp.unlink()
                removed += 1
        except OSError:
            continue
    return removed


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
    gc_stale_tmp(cache_dir, max_age_s=86400.0)
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


def drop_arrays(key: str, cache_dir: Optional[str] = None) -> bool:
    """Remove a cached entry (best effort); True if a file was deleted.
    The campaign engine retires its slice checkpoints with it once the
    whole-campaign entry is stored."""
    try:
        (Path(cache_dir or default_cache_dir()) / f"{key}.npz").unlink()
        return True
    except OSError:
        return False


# Lockless work claims (DESIGN.md §14).  Processes sharing one cache
# directory dedupe work by claiming a content key before computing it:
# ``O_CREAT | O_EXCL`` on ``<key>.claim`` is atomic, so one process wins
# each key with no lock server.  A claim is advisory (the store stays
# atomic whoever writes); a claim older than a TTL is presumed orphaned by
# a dead process and may be stolen, and a rare double computation after a
# steal is wasteful, never wrong.

def claim_path(key: str, cache_dir: Optional[str] = None) -> Path:
    return Path(cache_dir or default_cache_dir()) / f"{key}.claim"


def try_claim(key: str, cache_dir: Optional[str] = None,
              owner: str = "") -> bool:
    """Atomically claim ``key`` for this process; False if already
    claimed."""
    d = Path(cache_dir or default_cache_dir())
    d.mkdir(parents=True, exist_ok=True)
    try:
        fd = os.open(claim_path(key, cache_dir),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(json.dumps({"pid": os.getpid(), "owner": owner}))
    return True


def release_claim(key: str, cache_dir: Optional[str] = None) -> bool:
    """Drop the claim on ``key`` (best effort); True if a file was
    deleted."""
    try:
        claim_path(key, cache_dir).unlink()
        return True
    except OSError:
        return False


def claim_age_s(key: str, cache_dir: Optional[str] = None) -> Optional[float]:
    """Seconds since ``key`` was claimed, or None when it is unclaimed."""
    try:
        return max(0.0, time.time() - claim_path(key, cache_dir).stat().st_mtime)
    except OSError:
        return None


def steal_claim(key: str, ttl_s: float, cache_dir: Optional[str] = None,
                owner: str = "") -> bool:
    """Take over a claim older than ``ttl_s``: unlink, then claim again.
    Two stealers may both unlink, but one wins the ``O_EXCL`` create."""
    age = claim_age_s(key, cache_dir)
    if age is None or age < ttl_s:
        return False
    release_claim(key, cache_dir)
    return try_claim(key, cache_dir, owner=owner)


def gc_stale_claims(cache_dir: Optional[str] = None,
                    max_age_s: float = 3600.0) -> int:
    """Remove ``*.claim`` files older than ``max_age_s`` (claims of
    processes that died holding them); returns how many."""
    d = Path(cache_dir or default_cache_dir())
    if not d.is_dir():
        return 0
    cutoff = time.time() - max_age_s
    removed = 0
    for c in d.glob("*.claim"):
        try:
            if c.stat().st_mtime <= cutoff:
                c.unlink()
                removed += 1
        except OSError:
            continue
    return removed


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
