"""One run of one cell: set-up, warm-up, a measured window, the check
against the plain reference and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The driver module that the cell's traffic mix names does the work behind
four calls: ``setup(run)`` (weights and inputs from the seed, the program's
own set-up, every shape of the window warmed), ``window(run, seconds)``
(the closed loop, filling ``run.records``), ``end_to_end(run)`` (the
cell's end-to-end numbers from those records) and ``check(run)`` (the
comparison with the reference, once the program's state is freed).  The
per-layer numbers of a traced run come from the readers in
``bench/metrics``.  The process that prints the result refuses to print
it where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from benchlib.registry import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What one run knows; drivers and readers read and fill it."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_process: float):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.t_process = t_process
        self.state = {}          # the program's objects (freed before check)
        self.records = []        # one per completed request / step
        self.window_s = 0.0
        self.traced = None       # trace.Traced of a traced run
        self.info = {}           # numbers printed on earlier lines


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    loaded modules), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_name(torch) -> str:
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, driver) -> None:
    """Set-up, then the window (traced or not)."""
    import torch

    from benchlib.trace import Traced

    cuda = run.device.type == "cuda"
    driver.setup(run)
    sync(run.device)
    run.setup_s = time.perf_counter() - run.t_process
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    with Traced(run.trace) as tr:
        with tr.window():
            t0 = time.perf_counter()
            driver.window(run, run.seconds)
            sync(run.device)
            run.window_s = time.perf_counter() - t0
    run.traced = tr if run.trace else None
    run.memory_peak = (torch.cuda.max_memory_allocated(run.device) if cuda
                       else 0)


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> dict:
    """Everything after the look for a card: returns the result line."""
    import torch

    run = Run(cell, seed, seconds, trace, device, t_process)
    driver = cell.driver()
    measure(run, driver)
    metrics = per_layer(run) if run.trace else driver.end_to_end(run)
    if not run.trace:
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    kind = card_name(torch) if device.type == "cuda" else "cpu"
    result = {
        "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(run.memory_peak)},
    }
    if run.trace:
        tr = run.traced
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        run.info["trace_read_s"] = tr.read_s
    if device.type == "cuda":
        run.info["card"] = power_limit()
    for k, v in run.info.items():
        log(f"{k}: {v}")
    # the program's objects go before the reference runs on the card
    run.state.clear()
    run.traced = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(run)
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and run.failed == 0)
    return {"correct": correct, **result, "checks": checks}


def main(argv, t_process: float) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{found}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), t_process)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of {bad} are loaded after the window: the benchmark "
            "runs without JAX and the JAX package")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
