#!/usr/bin/env python3
"""Where a training step of the port goes on the card.

    python3 tools/train_profile.py [--seq 4096] [--batch 4]
                                   [--microbatches 2] [--layers 24]

qwen2-0.5b at its published widths (``--layers`` cuts the depth), float32
parameters and AdamW state, bfloat16 compute, the train step of
``launch.steps.make_train_step`` on the pipeline's batches.  Prints:

1. wall ms of 3 steps after 2 warm ones (host clock; each ends in a
   device sync);
2. one more step under ``torch.profiler`` (CPU and CUDA): the device's
   busy share (kernel time summed, over the step's wall) and the 12
   kernels with the most device time;
3. the step's parts run alone at its shapes, CUDA-event times: one
   layer's chunked self-attention forward and forward + backward (q (B /
   microbatches, S, 14, 64), k / v (.., 2, 64)), with the (query block,
   key chunk) tiles it computes of all there are; the chunked
   cross-entropy's forward and forward + backward over one microbatch; the
   AdamW update of the whole tree.  Each is scaled by its count per step:
   a remat region runs its forward twice (once in the forward, once
   recomputed in the backward) and its backward once, per layer and
   microbatch.

Needs one CUDA device.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cuda_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--layers", type=int, default=24)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_profile.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("qwen2-0.5b"), n_layers=args.layers)
    shape = ShapeConfig("profile", "train", args.seq, args.batch,
                        microbatches=args.microbatches)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    m, v = adamw_init(params)
    step_fn = ST.make_train_step(cfg, shape, AdamWConfig(lr=3e-3))
    dcfg = data_config(cfg, shape)
    step = 100

    def one_step():
        nonlocal params, m, v, step
        b = {k: torch.from_numpy(a).to(dev)
             for k, a in batch_at(dcfg, step).items()}
        params, m, v, step, met = step_fn(params, m, v, step, b)
        return float(met["loss"])

    for _ in range(2):
        one_step()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"wall per step: {', '.join(f'{w:.1f}' for w in walls)} ms "
          f"(B {args.batch} x S {args.seq}, {args.microbatches} "
          f"microbatches, {args.layers} layers)", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's mirrors of the program's spans (``repro.*``) are no work
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("repro.")]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled step: wall {wall:.1f} ms, device kernel time "
          f"{busy:.1f} ms, busy share {busy / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms  {e.count:6d} x  "
              f"{e.key[:100]}")

    Bm = args.batch // args.microbatches
    S, reps = args.seq, cfg.n_layers * args.microbatches
    g = torch.Generator(dev).manual_seed(1)
    bf = torch.bfloat16

    def rnd(*shape_):
        return torch.randn(*shape_, generator=g, device=dev).to(bf)

    q = rnd(Bm, S, cfg.n_heads, cfg.d_head).requires_grad_()
    k = rnd(Bm, S, cfg.n_kv_heads, cfg.d_head).requires_grad_()
    vv = rnd(Bm, S, cfg.n_kv_heads, cfg.d_head).requires_grad_()
    fn = A.chunked_attention if S > A.CHUNK_THRESHOLD else A.full_attention

    def attn_fwd():
        with torch.no_grad():
            fn(q, k, vv, cfg, causal=True, window=None)

    def attn_both():
        o = fn(q, k, vv, cfg, causal=True, window=None)
        torch.autograd.grad(o, [q, k, vv], torch.ones_like(o))

    h = rnd(Bm, min(S, M.LOSS_CHUNK), cfg.d_model).requires_grad_()
    w = params["embed"].T.to(bf).detach().requires_grad_()
    lab = torch.randint(0, cfg.vocab, (Bm, min(S, M.LOSS_CHUNK)),
                        generator=g, device=dev)
    n_chunks = max(1, S // M.LOSS_CHUNK) * args.microbatches

    def ce_fwd():
        with torch.no_grad():
            M._ce_chunk(h, lab, w, cfg)

    def ce_both():
        out = M._ce_chunk(h, lab, w, cfg)
        torch.autograd.grad(out[0], [h, w])

    grads = [torch.ones_like(p) for p in tree_leaves(params)]
    gtree = dict(zip(range(len(grads)), grads))
    ptree = dict(zip(range(len(grads)), tree_leaves(params)))
    mtree = dict(zip(range(len(grads)), tree_leaves(m)))
    vtree = dict(zip(range(len(grads)), tree_leaves(v)))

    def update():
        adamw_update(ptree, gtree, mtree, vtree, 100, AdamWConfig())

    parts = {
        "attention": (cuda_ms(torch, attn_fwd), cuda_ms(torch, attn_both),
                      reps),
        "cross-entropy chunk": (cuda_ms(torch, ce_fwd),
                                cuda_ms(torch, ce_both), n_chunks),
    }
    step_ms = sum(walls) / len(walls)
    plan = A.tile_plan(S, S, 0, True, None)
    tiles = {"attention": f" ({sum(map(len, plan))} of "
                          f"{len(plan) * len(plan)} tiles computed)"
             if fn is A.chunked_attention else ""}
    for name, (f, fb, n) in parts.items():
        total = n * (f + fb)
        print(f"{name}{tiles.get(name, '')}: forward {f:.2f} ms, forward + "
              f"backward {fb:.2f} ms; x {n} per step (forward twice, "
              f"backward once): {total:.1f} ms = "
              f"{100 * total / step_ms:.1f}% of the step")
    u = cuda_ms(torch, update)
    print(f"AdamW update: {u:.1f} ms = {100 * u / step_ms:.1f}% of the step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak memory allocated {peak:.2f} GiB")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
