#!/usr/bin/env python3
"""Time this checkout's fake-analog MVM (and bit-line MAC) against another
checkout's, in turns.

    python3 tools/analog_ab.py --other DIR [--reps 3]

``DIR`` is the root of another checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory.
Both trees' ``repro_torch.kernels.fake_analog`` and ``bitline_mac`` are
imported into this one process (the other's beside this one's); each
builds its own libraries under its own ``build/``.  At each of
qwen2-0.5b's five full-width launch shapes (M = 128; the operands of
``chip_smoke.py`` phase 5a) the fake-analog MVM runs in two instances, the
model path's (no FET, no fail plane) and the FET + fail one (the ss
corner's round trip and a write-BER fail plane), and the bit-line MAC at
adc 8 on the path's g_diff.  Both trees' outputs must be bit-equal; each
kernel is timed ``reps`` times in turns (other, this, this, other) as
device time, calls replayed from one CUDA graph of ~2 ms
(``chip_smoke.turn_calls``, as the smoke times B5 against B3).  The other
tree's B5 over its B3 at each shape is what ``chip_smoke.py`` holds this
tree's B5 to (``PARENT_B5_OVER_B3``).  Then the
``-Xptxas -v`` lines of both builds (registers, stack, spills per
instance).  Exits 1 if the outputs differ or this tree's fake-analog MVM
is more than 3% slower than the other's at any shape.  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NO_SLOWER = 1.03


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("analog_ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    from llg_ab import import_other
    from repro_torch.kernels import bitline_mac, build, fake_analog

    mods = import_other(args.other.resolve(), "kernels.fake_analog",
                        "kernels.bitline_mac")
    other_fake = mods["kernels.fake_analog"].fake_analog_kernel
    other_mac = mods["kernels.bitline_mac"].bitline_mac_kernel
    assert other_fake is not fake_analog.fake_analog_kernel
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    dev = torch.device("cuda")
    records = []
    slower = []
    for k, n, what in chip_smoke.QWEN_SHAPES:
        m = chip_smoke.QWEN_M
        x, w, bl, _ = chip_smoke.model_operands(torch, dev, m, k, n)
        sets = chip_smoke.fake_operand_sets(x, w, bl, dev)
        ops_p = sets["path"][0]
        g_p = fake_analog._tile_g_diff(ops_p[1], ops_p[2], ops_p[3],
                                       apply_fet=False, use_fail=False)
        i_max = ops_p[3][fake_analog.ROW_I_MAX, 0].item()
        calls = {f"fake_analog {label}": (
                     lambda ops=ops, fk=fk: other_fake(*ops, **fk),
                     lambda ops=ops, fk=fk: fake_analog.fake_analog_kernel(
                         *ops, **fk))
                 for label, (ops, fk) in sets.items()}
        calls["bitline_mac adc 8"] = (
            lambda: other_mac(ops_p[0], g_p, 8, i_max),
            lambda: bitline_mac.bitline_mac_kernel(ops_p[0], g_p, 8, i_max))
        for kernel, (other, this) in calls.items():
            if not torch.equal(other(), this()):
                raise AssertionError(f"{kernel} {what}: the two trees' "
                                     f"outputs differ")
            times = {"other": [], "this": []}
            fns = {"other": other, "this": this}
            n_calls = chip_smoke.turn_calls(
                chip_smoke.graph_ms(torch, this, 10))
            for _ in range(args.reps):
                for key in ("other", "this", "this", "other"):
                    times[key].append(
                        chip_smoke.graph_ms(torch, fns[key], n_calls))
            mean = {key: sum(v) / len(v) for key, v in times.items()}
            rec = dict(kernel=kernel, what=what, shape=[m, k, n],
                       calls=n_calls,
                       other_ms_device=mean["other"],
                       this_ms_device=mean["this"],
                       ratio=mean["this"] / mean["other"], runs=times)
            records.append(rec)
            flag = ""
            if kernel.startswith("fake_analog") and rec["ratio"] > NO_SLOWER:
                slower.append(f"{kernel} {what}")
                flag = ", SLOWER"
            print(f"{what} ({m}x{k} @ {k}x{n}) {kernel}: other "
                  f"{mean['other']:.4f} ms, this {mean['this']:.4f} ms "
                  f"(this / other {rec['ratio']:.4f}{flag}); outputs "
                  f"bit-equal", flush=True)
    by = {(r["what"], r["kernel"]): r for r in records}
    over_b3 = {}
    for _, _, what in chip_smoke.QWEN_SHAPES:
        b3 = by[(what, "bitline_mac adc 8")]
        b5 = by[(what, "fake_analog path")]
        over_b3[what] = {tree: b5[f"{tree}_ms_device"] / b3[f"{tree}_ms_device"]
                         for tree in ("other", "this")}
        print(f"{what}: fake_analog path / bitline_mac adc 8, other "
              f"{over_b3[what]['other']:.4f}, this "
              f"{over_b3[what]['this']:.4f}")
    print("ptxas, other tree (analog_mac.cu: B3 and B5):")
    for line in chip_smoke.ptxas_lines(
            mods["kernels.build"].build_log("analog_mac")):
        print("  ", line)
    for name in ("analog_mac", "fake_analog"):
        print(f"ptxas, this tree ({name}.cu):")
        for line in chip_smoke.ptxas_lines(build.build_log(name)):
            print("  ", line)
    print(smi)
    print(json.dumps({"analog_ab": records, "b5_over_b3": over_b3}))
    if slower:
        print("this tree's fake_analog more than 3% slower: "
              + "; ".join(slower), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
