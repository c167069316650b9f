"""The port's trainer (``repro.launch.train`` on one device):
``python -m repro_torch.launch.train --arch qwen2-0.5b --preset smoke``.

Presets:
  smoke  — the arch's reduced config, a small batch (minutes on a CPU)
  full   — the arch's real config at the ``train_4k`` shape

Wires the substrates together: config registry -> model -> data pipeline
-> AdamW -> fault-tolerant loop (checkpoint / resume, a SIGTERM
preemption save, the straggler watchdog).  ``train`` is the loop for any
config and shape (``chip_smoke.py`` drives it at full width); ``main`` is
the reference's CLI plus ``--device`` and ``--mesh``.

With a model mesh (``train(..., mesh=)``; ``main --mesh D,M`` over the
ranks of ``torchrun`` or any launcher that sets ``RANK`` / ``WORLD_SIZE``
/ ``MASTER_ADDR`` / ``MASTER_PORT``) each rank keeps its shards of the
parameters and moments and its rows of every batch, and the step is
``launch.sharded_step``'s (the reference's sharded jit with its parameter
and batch shardings); checkpoints are ``ShardedCheckpointer``'s, one
payload per rank, and restore onto whatever mesh the run comes up with.
The loop stops on SIGTERM only when every rank has seen it (the flag is
reduced over the mesh each step), so the ranks save the same step.
Without a mesh ``train`` is the one-device trainer.

A resumed run continues the data stream where the checkpoint left it
(``data.batch_at`` of the checkpoint's step), as the pipeline's
determinism contract says, so a run interrupted and resumed trains on the
same batches as one that was not.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint import Checkpointer, ShardedCheckpointer
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.sharded_step import ShardPlan
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultTolerantLoop


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One logged step: the loss, gradient norm and learning rate it
    reported, and its wall time (host clock around the batch and the step,
    which ends in reading the metrics, so in a device sync)."""
    step: int
    loss: float
    grad_norm: float
    lr: float
    ms: float
    straggler: bool


def data_config(cfg: ArchConfig, shape: ShapeConfig,
                seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab=cfg.vocab, seq_len=ST.text_len(cfg, shape),
        global_batch=shape.global_batch, microbatches=shape.microbatches,
        seed=seed, frontend_positions=cfg.frontend_positions,
        d_model=cfg.d_model, encoder_frames=bool(cfg.n_encoder_layers))


def train(cfg: ArchConfig, shape: ShapeConfig, opt_cfg: AdamWConfig,
          steps: int, ckpt_dir, save_every: int = 25, log_every: int = 5,
          device=None, seed: int = 0, step0: Optional[int] = None,
          total_steps: Optional[int] = None, mesh=None) -> List[StepRecord]:
    """Train ``cfg`` on ``shape``'s synthetic batches up to step
    ``steps`` on ``device`` (None = the CUDA device), checkpointing every
    ``save_every`` steps under ``ckpt_dir/<arch>`` and resuming from the
    latest checkpoint there.  A fresh run starts at step ``step0`` (None =
    0).  The learning rate follows ``wsd_schedule`` over ``total_steps``
    (None = ``steps``, as the reference's ``--steps``).  Parameters are
    ``init_params`` from ``seed``.  With a model ``mesh`` (a
    ``DeviceMesh`` over the initialized process group) every rank calls
    ``train`` alike; rank 0 prints.  Returns the logged steps' records."""
    dev = resolve_device(device)
    plan = None if mesh is None else ShardPlan(cfg, mesh)
    lead = plan is None or plan.rank == 0
    if lead:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"active={cfg.active_param_count()/1e6:.1f}M device={dev}"
              + ("" if plan is None else f" mesh={plan.sizes}"))

    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    if plan is not None:
        params = plan.shard(params)
    params = tree_map(lambda p: p.requires_grad_(), params)
    m, v = adamw_init(params, cfg.opt_state_dtype)
    train_step = ST.make_train_step(cfg, shape, opt_cfg,
                                    total_steps=total_steps or steps,
                                    plan=plan)
    data_cfg = data_config(cfg, shape)

    ckpt = (Checkpointer(Path(ckpt_dir) / cfg.name) if plan is None else
            ShardedCheckpointer(Path(ckpt_dir) / cfg.name, plan))
    start = step0 or 0
    latest = ckpt.latest_step()
    if latest is not None:
        restored = ckpt.restore(latest, {
            "params": params, "m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32)}, device=dev)
        params = tree_map(lambda p: p.requires_grad_(), restored["params"])
        m, v = restored["m"], restored["v"]
        start = int(restored["step"])
        del restored
        if lead:
            print(f"resumed from checkpoint step {latest}")
    # the loop gets the only reference to the first state, so it is freed
    # after the first step (parameters and moments: 6 GB for qwen2-0.5b)
    first = [(params, m, v, start)]
    del params, m, v

    history: List[StepRecord] = []

    def step_fn(state, batch):
        params, m, v, step = state
        if plan is not None:
            batch = plan.shard_batch(shape, batch)
        batch = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
        params, m, v, step, metrics = train_step(params, m, v, step, batch)
        if plan is not None:
            loop.preempted = plan.any_rank(loop.preempted, dev)
        return (params, m, v, step), {k: float(x) for k, x in
                                      metrics.items()}

    def log(step, metrics, dt):
        straggler = bool(metrics.get("straggler"))
        if step % log_every == 0 or straggler:
            history.append(StepRecord(step, metrics["loss"],
                                      metrics["grad_norm"], metrics["lr"],
                                      dt * 1e3, straggler))
            if lead:
                print(f"step {step:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                      + (" STRAGGLER" if straggler else ""))

    class _StateCkpt:
        """The loop's (params, m, v, step) state as the checkpoint tree."""

        def save(self, step, state, blocking=False):
            params, m, v, s = state
            ckpt.save(step, {"params": params, "m": m, "v": v,
                             "step": torch.tensor(s, dtype=torch.int32)},
                      blocking=blocking)

        def wait(self):
            ckpt.wait()

    t0 = time.time()
    with FaultTolerantLoop(_StateCkpt(), save_every=save_every) as loop:
        _, final_step, watchdog = loop.run(
            first.pop(), step_fn, lambda step: batch_at(data_cfg, step),
            start, steps, log)
    if lead:
        print(f"trained to step {final_step} in {time.time()-t0:.1f}s; "
              f"stragglers={len(watchdog.straggler_steps)}")
    if lead and len(history) >= 2:
        print(f"loss: {history[0].loss:.4f} -> {history[-1].loss:.4f}")
    return history


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else the launcher's
    ``LOCAL_RANK``-th CUDA device (modulo the visible cards, so ranks
    beyond them share cards)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one GPU; gloo takes CUDA tensors)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train on a (data D, model M) mesh over the ranks "
                         "of the launcher's process group (torchrun)")
    args = ap.parse_args(argv)

    if args.preset == "smoke":
        cfg = smoke_config(args.arch)
        shape = ShapeConfig("custom", "train", args.seq, args.batch,
                            microbatches=args.microbatches)
    else:
        cfg = get_arch(args.arch)
        shape = ShapeConfig("train_4k", "train", 4096, 256,
                            microbatches=args.microbatches)
    kw = dict(save_every=args.save_every, log_every=args.log_every)
    if args.mesh is None:
        history = train(cfg, shape, AdamWConfig(lr=args.lr), args.steps,
                        args.ckpt_dir, device=args.device, **kw)
        return [(r.step, r.loss) for r in history]
    data, model = (int(x) for x in args.mesh.split(","))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if data * model != world:
        raise ValueError(f"--mesh {args.mesh} needs {data * model} ranks; "
                         f"the world has {world}")
    device = rank_device(args.device)
    torch.distributed.init_process_group(backend_for(device, world))
    try:
        mesh = make_local_mesh(model, device_type=device.type)
        history = train(cfg, shape, AdamWConfig(lr=args.lr), args.steps,
                        args.ckpt_dir, device=device, mesh=mesh, **kw)
    finally:
        torch.distributed.destroy_process_group()
    return [(r.step, r.loss) for r in history]


if __name__ == "__main__":
    main()
