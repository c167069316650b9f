#!/usr/bin/env python3
"""Time this checkout's LLG kernel against another checkout's, in turns.

    python3 tools/llg_ab.py --other DIR [--reps 3]

``DIR`` is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Both trees' ``repro_torch.kernels.llg_rk4`` are imported into this one
process (the other's beside this one's); each builds its own library
under its own ``build/``.  The inputs are the campaign of ``chip_smoke.py``
phase 3 (600,000 lanes, 786,432 packed, x 2,501 steps), packed once by
this tree's campaign code; both wrappers launch it with their default
layouts, ``reps`` times in turns (other, this, this, other), timed with
CUDA events.  The two outputs must be bit-equal.  Then the ``-Xptxas -v``
lines of both builds (registers, stack, spills per instance) are printed.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "repro_torch"


def _ours() -> list:
    return [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]


def import_other(root: Path, *names: str) -> dict:
    """{name: module} of the modules ``names`` (dotted, under the package)
    and of ``kernels.build``, from the checkout under ``root``, imported
    beside this tree's modules, which stay in ``sys.modules``."""
    mine = {k: sys.modules.pop(k) for k in _ours()}
    sys.path.insert(0, str(root / "src"))
    try:
        mods = {n: importlib.import_module(f"{PKG}.{n}") for n in names}
        mods["kernels.build"] = sys.modules[f"{PKG}.kernels.build"]
    finally:
        sys.path.remove(str(root / "src"))
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("llg_ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build, llg_rk4

    mods = import_other(args.other.resolve(), "kernels.llg_rk4")
    other, other_build = mods["kernels.llg_rk4"], mods["kernels.build"]
    assert other.llg_rk4_kernel is not llg_rk4.llg_rk4_kernel
    print(chip_smoke.nvidia_smi(), flush=True)

    dev = torch.device("cuda")
    shape = chip_smoke.pack_shape(dev, "afmtj", chip_smoke.campaign_grid())
    args_ = (shape["state"], shape["p"], shape["dt"], shape["n_kernel"])
    call = {"other": lambda: other.llg_rk4_kernel(*args_, **shape["kw"]),
            "this": lambda: llg_rk4.llg_rk4_kernel(*args_, **shape["kw"])}
    outs = {k: f() for k, f in call.items()}      # build, load and warm
    if not torch.equal(outs["other"], outs["this"]):
        raise AssertionError("the two trees' kernels disagree")
    times = {"other": [], "this": []}
    for _ in range(args.reps):
        for k in ("other", "this", "this", "other"):
            times[k].append(chip_smoke.cuda_ms(call[k])[1])
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    rec = dict(lanes=shape["state"].shape[1], steps=shape["steps"],
               other_ms=mean["other"], this_ms=mean["this"],
               ratio=mean["this"] / mean["other"], runs=times)
    print(f"campaign ({rec['lanes']} lanes x {rec['steps']} steps): other "
          f"{mean['other']:.3f} ms, this {mean['this']:.3f} ms (this / "
          f"other {rec['ratio']:.4f}; runs {times}); outputs bit-equal",
          flush=True)
    print("ptxas, other tree:")
    for line in chip_smoke.ptxas_lines(other_build.build_log("llg_rk4")):
        print("  ", line)
    print("ptxas, this tree:")
    for line in chip_smoke.ptxas_lines(
            build.build_log("llg_rk4", llg_rk4.BUILD_DEFINES)):
        print("  ", line)
    print(json.dumps({"llg_ab_campaign": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
