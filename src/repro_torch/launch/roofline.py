"""Roofline analysis over the port's dry-run records (port of
``repro.launch.roofline``).

Per (arch x shape) cell, one rank of the mesh on NVIDIA H100 SXM
data-sheet rates:

  compute term    = the rank's FLOPs / 989 TFLOP/s    (dense bf16 peak)
  memory term     = the rank's bytes / 3.35 TB/s      (HBM3)
  collective term = the rank's collective bytes / 50 GB/s (link per GPU)

These are analytic bounds from data-sheet constants, not times taken on
a card.  The compute term reads ``flops_rank``, what the port's rank
computes (``launch.dryrun``: gathered weights, so the ranks along
``model`` repeat each other's work); it falls back to
``flops_audit_per_device`` and then to ``cost["flops"]`` so that a record
of the reference's schema, which has neither ``flops_rank`` nor the
port's meaning, reads as the reference reads it.  The memory term reads
``cost["bytes accessed"]``, which for the port is every op's input and
output bytes with no fusion.

``LINK_BW`` takes the place of the reference's ICI rate: 50 GB/s per GPU
is InfiniBand NDR at 400 Gb/s.  Every axis of the (16, 16) and (2, 16,
16) meshes spans more than one 8-GPU NVLink node, so its collectives
cross the network; NVLink's 450 GB/s per direction applies only inside a
node.

MODEL_FLOPS uses 6 N_active D for training and 2 N_active D for
inference steps, over all devices; the ratio MODEL/HLO exposes remat,
dispatch and, here, the model axis's repeated work.

Usage:
  python -m repro_torch.launch.roofline           # table to stdout
  python -m repro_torch.launch.roofline --md results/roofline_torch.md
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_arch

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12           # B/s, H100 SXM HBM3
LINK_BW = 50e9             # B/s per GPU, InfiniBand NDR 400 Gb/s
# one H100 80GB HBM3's memory as torch.cuda.mem_get_info gives its total
# (79.18 GiB; chip_smoke.py prints it in phase 0)
CARD_BYTES = 85_017_493_504

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops_per_device(arch: str, shape_name: str,
                           n_devices: int) -> float:
    cfg = get_arch(arch)
    s = SHAPES[shape_name]
    n = cfg.active_param_count()
    if s.kind == "train":
        total = 6.0 * n * s.global_batch * s.seq_len
    elif s.kind == "prefill":
        total = 2.0 * n * s.global_batch * s.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n * s.global_batch
    return total / n_devices


def load_cells(mesh: str = "pod") -> List[Dict]:
    return [json.loads(f.read_text())
            for f in sorted(RESULTS.glob(f"*__{mesh}.json"))]


def bound_terms(cell: Dict) -> Dict:
    """The cell's three terms (s), the dominant one and their max."""
    flops = (cell.get("flops_rank") or cell.get("flops_audit_per_device")
             or cell["cost"]["flops"])
    coll = sum(v["bytes"] for v in cell["collectives"].values())
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": cell["cost"]["bytes accessed"] / HBM_BW,
             "collective": coll / LINK_BW}
    dom = max(terms.items(), key=lambda kv: kv[1])[0]
    return {"t_compute": terms["compute"], "t_memory": terms["memory"],
            "t_collective": terms["collective"], "dominant": dom,
            "bound": terms[dom], "flops": flops, "coll_bytes": coll}


def analyze(cell: Dict) -> Dict:
    b = bound_terms(cell)
    mf = model_flops_per_device(cell["arch"], cell["shape"],
                                cell["n_devices"])
    bound = b["bound"]
    # roofline fraction: useful model FLOPs per device over what the card
    # could have done in the bound time (the MFU-analog of a dry run)
    frac = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return {
        **cell,
        "t_compute": b["t_compute"],
        "t_memory": b["t_memory"],
        "t_collective": b["t_collective"],
        "dominant": b["dominant"],
        "model_flops_dev": mf,
        "useful_ratio": mf / b["flops"] if b["flops"] else 0.0,
        "roofline_frac": frac,
        "coll_bytes": b["coll_bytes"],
    }


def fits(cell: Dict) -> bool:
    """Whether the rank's argument and temp bytes fit on one card."""
    m = cell["memory"]
    return m["argument_size_in_bytes"] + m["temp_size_in_bytes"] \
        <= CARD_BYTES


def fmt_table(cells: List[Dict]) -> str:
    rows = [
        "| arch | shape | Tcomp (ms) | Tmem (ms) | Tcoll (ms) | dominant | "
        "MODEL/HLO | roofline frac | bytes/dev (GB) | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    order = {k: i for i, k in enumerate(ARCHS)}
    cells = sorted(cells, key=lambda c: (order.get(c["arch"], 99),
                                         c["shape"]))
    for c in cells:
        mem_gb = (c["memory"]["argument_size_in_bytes"]
                  + c["memory"]["temp_size_in_bytes"]) / 1e9
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['t_compute']*1e3:.3f} | "
            f"{c['t_memory']*1e3:.3f} | {c['t_collective']*1e3:.3f} | "
            f"{c['dominant']} | {c['useful_ratio']:.2f} | "
            f"{c['roofline_frac']*100:.1f}% | {mem_gb:.2f} | "
            f"{'yes' if fits(c) else 'no'} |")
    return "\n".join(rows)


def pick_hillclimb(cells: List[Dict]) -> Dict[str, Dict]:
    """worst roofline fraction / most collective-bound / most representative
    (largest simulated-system training cell — the paper-technique host)."""
    train = [c for c in cells if c["kind"] == "train"]
    worst = min(cells, key=lambda c: c["roofline_frac"])
    coll = max(cells, key=lambda c: c["t_collective"] /
               max(c["t_compute"], c["t_memory"], 1e-12))
    rep = max(train, key=lambda c: c["params_total"])
    return {"worst_fraction": worst, "most_collective": coll,
            "representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    cells = [analyze(c) for c in load_cells(args.mesh)]
    table = fmt_table(cells)
    picks = pick_hillclimb(cells)
    lines = [f"## Roofline ({args.mesh} mesh, {cells[0]['n_devices']} "
             "GPUs; analytic bounds from H100 SXM data-sheet rates)",
             "", table, "", "### Hillclimb picks", ""]
    for k, c in picks.items():
        lines.append(f"- **{k}**: {c['arch']} x {c['shape']} "
                     f"(frac {c['roofline_frac']*100:.1f}%, dominant "
                     f"{c['dominant']})")
    text = "\n".join(lines)
    print(text)
    if args.md:
        Path(args.md).write_text(text + "\n")


if __name__ == "__main__":
    main()
