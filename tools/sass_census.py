#!/usr/bin/env python3
"""Count the special-function-unit (MUFU) instructions of the LLG kernel per
RK4 step, from the SASS that nvcc builds for sm_90a.

    python3 tools/sass_census.py          # on a machine with the CUDA toolkit

Builds ``src/repro_torch/kernels/csrc/llg_rk4.cu`` as the port does (or
reuses the built library), disassembles it with ``cuobjdump -sass`` and, for
every template instance (THERMAL, VARIATION, NSUB), prints the MUFU
instructions by kind inside the step loops, divided by the number of copies
of the step body (1 for the deterministic kernel; 2 for the thermal kernel,
which holds one copy in its fixed-horizon loop and one in its chunked
loop).  The loop region runs from the lowest backward-branch target to the
last EXIT before the out-of-line slow paths (IEEE division and sqrt
subroutines), so loop-invariant MUFUs before the loops and the rarely taken
slow paths are left out.  It also prints the whole instance's MUFU totals
and its local-memory instructions.  ``chip_smoke.py`` carries the per-step
counts in its operation bound.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TEMPLATE = re.compile(r"llg_rk4_kernelILb(\d)ELb(\d)ELi(\d)E")


def instance_census(sass: str) -> dict:
    ins = [(int(m.group(1), 16), m.group(2)) for m in INSTR.finditer(sass)]
    back_targets = []
    for addr, text in ins:
        t = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if t and int(t.group(1), 16) < addr:
            back_targets.append(int(t.group(1), 16))
    first_ret = min((a for a, t in ins if re.search(r"\bRET\b", t)),
                    default=ins[-1][0] + 1)
    end = max(a for a, t in ins if re.search(r"\bEXIT\b", t) and a < first_ret)
    start = min(back_targets)
    loop = collections.Counter(
        m.group(1) for a, t in ins if start <= a <= end
        for m in [re.search(r"\bMUFU\.(\w+)", t)] if m)
    total = collections.Counter(
        m.group(1) for _, t in ins for m in [re.search(r"\bMUFU\.(\w+)", t)] if m)
    local = sum(1 for _, t in ins if re.search(r"\b(LDL|STL)\b", t))
    return dict(loop=dict(loop), total=dict(total), local_mem_instrs=local,
                instructions=len(ins))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build("llg_rk4")
    lib = build.library_path("llg_rk4")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    rows = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = TEMPLATE.search(part.split("\n", 1)[0])
        if not m:
            continue
        thermal, variation, nsub = bool(int(m[1])), bool(int(m[2])), int(m[3])
        c = instance_census(part)
        copies = 2 if thermal else 1
        per_step = {k: v / copies for k, v in c["loop"].items()}
        rows.append(dict(thermal=thermal, variation=variation, nsub=nsub,
                         mufu_per_step=per_step,
                         sfu_per_step=sum(per_step.values()),
                         step_copies=copies, mufu_total=c["total"],
                         local_mem_instrs=c["local_mem_instrs"],
                         instructions=c["instructions"]))
        print(f"THERMAL={int(thermal)} VARIATION={int(variation)} NSUB={nsub}:"
              f" MUFU per step {per_step} (sum {sum(per_step.values()):g}),"
              f" whole instance {c['total']}, {c['local_mem_instrs']} LDL/STL,"
              f" {c['instructions']} instructions", flush=True)
    print(json.dumps({"sass_census": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
