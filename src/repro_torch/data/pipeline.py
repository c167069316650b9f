"""Deterministic sharded data pipeline (the port's own copy of
``repro.data.pipeline``; numpy only).

Sources:
  * synthetic — seeded zipfian token stream (the offline default);
  * memmap    — packed uint16/uint32 token files, sliced per host so each
                data-parallel rank reads only its shard.

Determinism contract: batch content is a pure function of (seed, step,
host_rank), so a restart regenerates the identical stream position
(``batch_at``) and a rank remapping reshuffles cleanly (the rank enters
only through the slice offset).  Batches are numpy arrays equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None         # token file for memmap
    host_rank: int = 0
    host_count: int = 1
    frontend_positions: int = 0        # vlm/audio stub embeddings
    d_model: int = 0
    encoder_frames: bool = False


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish distribution over the vocab (more LM-like than uniform)."""
    u = rng.random(shape)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)
    return np.clip(vocab - ranks, 0, vocab - 1).astype(np.int32)


class _Memmap:
    def __init__(self, path: str, vocab: int):
        p = Path(path)
        dtype = np.uint32 if vocab > 65535 else np.uint16
        self.tokens = np.memmap(p, dtype=dtype, mode="r")

    def slice(self, start: int, n: int) -> np.ndarray:
        start = start % max(len(self.tokens) - n - 1, 1)
        return np.asarray(self.tokens[start:start + n], dtype=np.int32)


def _check(cfg: DataConfig) -> None:
    if cfg.global_batch % (cfg.host_count * cfg.microbatches):
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {cfg.host_count} hosts x {cfg.microbatches} "
                         "microbatches")


def batch_at(cfg: DataConfig, step: int,
             mm: Optional[_Memmap] = None) -> Dict[str, np.ndarray]:
    """The batch of ``step``: tokens / labels (microbatches,
    per_host_batch // microbatches, seq_len), plus frontend embeddings or
    encoder frames (..., frontend_positions, d_model) when configured."""
    _check(cfg)
    per_mb = cfg.global_batch // cfg.host_count // cfg.microbatches
    if cfg.source == "memmap" and mm is None:
        mm = _Memmap(cfg.path, cfg.vocab)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_rank]))
    shape = (cfg.microbatches, per_mb, cfg.seq_len + 1)
    if cfg.source != "memmap":
        toks = _zipf_tokens(rng, shape, cfg.vocab)
    else:
        n = int(np.prod(shape))
        base = (cfg.seed + step * cfg.host_count + cfg.host_rank) * n
        toks = mm.slice(base, n).reshape(shape)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.frontend_positions:
        fe = rng.standard_normal(
            (cfg.microbatches, per_mb, cfg.frontend_positions, cfg.d_model),
            dtype=np.float32)
        key = "encoder_frames" if cfg.encoder_frames else "frontend_embeds"
        batch[key] = fe
    return batch


def make_pipeline(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Yields the batches of steps 0, 1, 2, ..."""
    _check(cfg)
    mm = _Memmap(cfg.path, cfg.vocab) if cfg.source == "memmap" else None
    step = 0
    while True:
        yield batch_at(cfg, step, mm)
        step += 1
