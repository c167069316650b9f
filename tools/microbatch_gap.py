#!/usr/bin/env python3
"""How far the one-rank train step's gradient moves with the rows per
microbatch (GPU; ROADMAP C19).

    python3 tools/microbatch_gap.py [--layers 1 2 4 12 24]

qwen2-0.5b at its published widths in float32 compute (the model of
``chip_smoke.py`` phase 12c), B 4 x S 1,024 from the pipeline's step-0
batch, parameters from seed 0.  For each depth it prints |d| / |g| (L2
over the gradient tree) between the gradient in 2 microbatches of 2 rows
and: the same batch again, the same batch with the rows of each
microbatch reversed, and 4 microbatches of 1 row (a (2, *) mesh's data
rank takes 1 row of each of 2 microbatches).  The card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 12,
                                                              24])
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("microbatch_gap.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import batch_at
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import data_config
    from repro_torch.models import model as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    two = ShapeConfig("b4", "train", 1024, 4, microbatches=2)
    four = ShapeConfig("b4", "train", 1024, 4, microbatches=4)
    for layers in args.layers:
        cfg = dataclasses.replace(get_arch("qwen2-0.5b"),
                                  compute_dtype="float32", n_layers=layers)
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        batch = batch_at(data_config(cfg, two), 0)

        def grads(b, shape):
            b = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for k, a in b.items()}
            _, g = ST.make_grad_step(cfg, shape)(params, b)
            return [x.double() for x in tree_leaves(g)]

        def rel(u, v):
            d2 = sum(torch.sum((x - y) ** 2).item() for x, y in zip(u, v))
            return math.sqrt(d2 / sum(torch.sum(y ** 2).item() for y in v))

        ref = grads(batch, two)
        again = grads(batch, two)
        rev = grads({k: v[:, ::-1] for k, v in batch.items()}, two)
        ones = grads({k: v.reshape(4, 1, *v.shape[2:])
                      for k, v in batch.items()}, four)
        print(f"{layers} layers: again {rel(again, ref):.2e}, rows reversed "
              f"{rel(rev, ref):.2e}, 4 microbatches of 1 row "
              f"{rel(ones, ref):.2e}", flush=True)
        del params, ref, again, rev, ones
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
