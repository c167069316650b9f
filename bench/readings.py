#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's numbers and the
control's (the reference in the program's place at the precision below
the stated one) on several seeds, in one process, without a window.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--what program,control,fault:<name>]

Prints one JSON line per seed and kind.  On the card by default; the CPU
tests call the same driver functions at smoke size.
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.join(os.path.dirname(BENCH), "src")]

from benchlib import faults  # noqa: E402
from benchlib.harness import Run  # noqa: E402
from benchlib.registry import Cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    driver = cell.driver()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind in args.what.split(","):
            run = Run(cell, seed, 0.0, False, dev, time.perf_counter())
            t0 = time.perf_counter()
            if kind == "control":
                out = driver.control_readings(run)
            elif kind.startswith("fault:"):
                with faults.plant(cell.traffic["driver"], kind[6:],
                                  cell.config):
                    out = driver.program_readings(run)
            else:
                out = driver.program_readings(run)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "seconds": time.perf_counter() - t0,
                              "readings": out, "info": run.info}),
                  flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
