#!/usr/bin/env python3
"""Count the SASS instructions one RK4 step of the LLG kernel issues, by
class, for every template instance, from the code nvcc builds for sm_90a.

    python3 tools/sass_census.py                  # GPU machine (CUDA toolkit)
    python3 tools/sass_census.py --sass FILE      # a saved `cuobjdump -sass`
    python3 tools/sass_census.py --save FILE      # also keep the disassembly

Builds ``src/repro_torch/kernels/csrc/llg_rk4.cu`` as the port does (or
reuses the built library) and disassembles it with ``cuobjdump -sass``.
For every instance (THERMAL, VARIATION, NSUB, TPL threads per lane,
CLUSTER, PRODUCE) it finds the step loops (the innermost loops that hold a
MUFU.RCP: one in the deterministic kernel; two in the thermal kernel, the
fixed-horizon loop and the chunked loop) and walks the step's fast path:
the longest path from the loop head to its back edge that enters no slow
block.  Slow blocks are the ones that call out of line (the IEEE division
and sqrt slow paths) or lie in a loop nested in the step (the Payne-Hanek
reduction of sinf / cosf, for arguments far outside the Box-Muller
angle's [0, 2 pi), with its local-memory array); register spills on the
fast path count as its local-memory instructions.  That path is what one
thread issues per step; a lane-step is TPL times it, plus, with noise
producers, the fast path of the producers' loop that draws one step's
normals (the innermost loop with a MUFU.RSQ and no MUFU.RCP).  It prints the path's instructions
by class (fp32, int, cvt, mufu, shfl, branch, local, sync, uniform,
other), its MUFU instructions by kind, and, from the build's ``-Xptxas
-v`` log, each instance's registers, stack frame and spills.
``chip_smoke.py`` divides the fast path by the card's issue rate for the
issue floor.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
TEMPLATE = re.compile(
    r"llg_rk4_kernelILb(\d)ELb(\d)ELi(\d)ELi(\d)ELb(\d)ELb(\d)E")
WRITE_TEMPLATE = re.compile(r"llg_write_kernelILi(\d)E")
PRED = re.compile(r"^@(!?)(U?P[T0-9]+)\s+")
HEX = re.compile(r"0x([0-9a-f]+)")

CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET",
             "FSWZADD", "FADD32I", "FMUL32I", "FFMA32I"},
    "int": {"IADD3", "IMAD", "LOP3", "SHF", "ISETP", "LEA", "SEL", "IMNMX",
            "IABS", "POPC", "FLO", "PRMT", "BREV", "BMSK", "IADD", "IMUL",
            "LOP", "SHL", "SHR", "VIADD", "VIMNMX", "SGXT", "ISCADD", "IDP"},
    "cvt": {"I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND"},
    "mufu": {"MUFU"},
    "shfl": {"SHFL"},
    "branch": {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
               "BSYNC", "WARPSYNC", "BREAK", "BMOV", "KILL", "NANOSLEEP",
               "YIELD"},
    "local": {"LDL", "STL"},
    "sync": {"BAR", "MEMBAR", "FENCE", "ERRBAR", "UCGABAR_ARV",
             "UCGABAR_WAIT", "CCTL", "DEPBAR"},
}
OP_CLASS = {op: cls for cls, ops in CLASSES.items() for op in ops}
# instructions that end a basic block
CONTROL = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BREAK"}


class Ins:
    __slots__ = ("addr", "pred", "op", "base", "text")

    def __init__(self, addr: int, text: str):
        self.addr = addr
        m = PRED.match(text)
        self.pred = None if m is None else m.group(1) + m.group(2)
        body = text[m.end():] if m else text
        self.op = body.split()[0]
        self.base = self.op.split(".")[0]
        self.text = text

    @property
    def always(self) -> bool:      # executes unconditionally
        return self.pred in (None, "PT")

    @property
    def never(self) -> bool:
        return self.pred == "!PT"

    def target(self):
        if self.base not in ("BRA", "CALL", "BSSY"):
            return None
        t = HEX.findall(self.text.split(None, 1)[1] if " " in self.text
                        else "")
        return int(t[-1], 16) if t else None

    def klass(self) -> str:
        if self.base in OP_CLASS:
            return OP_CLASS[self.base]
        return "uniform" if self.base.startswith("U") else "other"


def basic_blocks(ins: list):
    """[(start index, end index exclusive)] and the successor block starts
    of each, by address."""
    at = {x.addr: i for i, x in enumerate(ins)}
    leaders = {0}
    for i, x in enumerate(ins):
        t = x.target()
        if t is not None and t in at:
            leaders.add(at[t])
        if x.base in CONTROL:
            leaders.add(i + 1)
    starts = sorted(s for s in leaders if s < len(ins))
    blocks = list(zip(starts, starts[1:] + [len(ins)]))
    succ = {}
    for s, e in blocks:
        last = ins[e - 1]
        out = []
        fall = ins[e].addr if e < len(ins) else None
        if last.base == "BRA" and not last.never:
            if last.target() is not None:
                out.append(last.target())
            if not last.always or ".DIV" in last.op or ".CONV" in last.op:
                out.append(fall)
        elif last.base in ("EXIT", "RET") and last.always:
            pass
        elif last.base in ("BRX", "JMP", "JMX"):
            pass
        else:
            out.append(fall)
        succ[ins[s].addr] = [a for a in out if a is not None]
    return blocks, succ


def fast_path(ins: list, holds: str = "MUFU.RCP", lacks: str = "") -> list:
    """The fast path of every innermost loop that holds the instruction
    ``holds`` and not ``lacks`` (the step loops by default; the producers'
    loops with ``MUFU.RSQ`` but no ``MUFU.RCP``): [{'head', 'latch',
    'nested', 'classes', 'ops', 'mufu', 'length'}] in address order."""
    blocks, succ = basic_blocks(ins)
    by_start = {ins[s].addr: (s, e) for s, e in blocks}
    # the kernel's body ends at its last EXIT before the out-of-line code:
    # the stubs a BRA.DIV takes when a shuffle's warp is diverged (they
    # jump back into the body) and the slow-path subroutines (RET)
    first_ret = min((x.addr for x in ins if x.base == "RET"),
                    default=ins[-1].addr + 1)
    end = max(x.addr for x in ins if x.base == "EXIT" and x.addr < first_ret)
    loops = []            # (head addr, latch addr) of every back edge
    for s, e in blocks:
        last = ins[e - 1]
        for t in succ[ins[s].addr]:
            if t <= last.addr <= end:
                loops.append((t, last.addr))

    def has(op, lo, hi):
        return any(lo <= x.addr <= hi and x.op == op for x in ins)

    def inside(a, b):     # loop a strictly inside loop b
        return b[0] <= a[0] and a[1] <= b[1] and a != b

    marked = [lp for lp in loops
              if has(holds, *lp) and not (lacks and has(lacks, *lp))]
    step_loops = [lp for lp in marked
                  if not any(inside(q, lp) for q in marked)]
    out = []
    for head, latch in sorted(set(step_loops)):
        inner = [q for q in loops if inside(q, (head, latch))]
        order = sorted(a for a in by_start if head <= a <= latch)

        def slow(a):
            s, e = by_start[a]
            if any(x.base == "CALL" for x in ins[s:e]):
                return True
            return any(q[0] <= a <= q[1] for q in inner)

        best, parent = {}, {}
        for a in order:
            if slow(a):
                continue
            s, e = by_start[a]
            if a == head:
                best[a], parent[a] = e - s, None
                continue
            preds = [p for p in best if a in succ[p] and p < a]
            if preds:
                p = max(preds, key=lambda q: best[q])
                best[a], parent[a] = best[p] + e - s, p
        latch_block = max(a for a in order if a <= latch)
        if latch_block not in best:
            raise RuntimeError(f"no fast path through the loop at "
                               f"{head:#x}-{latch:#x}")
        path, a = [], latch_block
        while a is not None:
            s, e = by_start[a]
            path = ins[s:e] + path
            a = parent[a]
        out.append(dict(
            head=head, latch=latch,
            nested=any(inside((head, latch), q) for q in loops),
            length=len(path),
            classes=dict(collections.Counter(x.klass() for x in path)),
            mufu=dict(collections.Counter(x.op.split(".", 1)[1]
                                          for x in path if x.base == "MUFU")),
            ops=dict(collections.Counter(x.base for x in path))))
    return out


def ptxas_resources(log: str) -> dict:
    """{mangled name: {'registers', 'stack', 'spill_stores', 'spill_loads'}}
    from an ``-Xptxas -v`` log."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            res[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            res[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m[1])
            name = None
    return res


def census(sass: str, log: str = "") -> list:
    """One row per kernel instance of a ``cuobjdump -sass`` listing."""
    resources = ptxas_resources(log)
    rows = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        m = TEMPLATE.search(name)
        if not m:
            continue
        ins = [Ins(int(a, 16), t) for a, t in INSTR.findall(part)]
        loops = fast_path(ins)
        thermal, produce, tpl = bool(int(m[1])), bool(int(m[6])), int(m[4])
        # the main path's loop: the chunked one (nested in the chunk loop)
        # in the thermal kernel, the only one in the deterministic kernel
        main = next((lp for lp in loops if lp["nested"]), loops[-1])
        # producers: the loop that draws one step's normals, in the chunk
        # loop (a lane-step is T lane threads' step + one producer's)
        prod = (next(lp for lp in fast_path(ins, "MUFU.RSQ", "MUFU.RCP")
                     if lp["nested"]) if produce else None)
        rows.append(dict(
            thermal=thermal, variation=bool(int(m[2])), nsub=int(m[3]),
            tpl=tpl, cluster=bool(int(m[5])), produce=produce,
            instructions_per_thread_step=main["length"],
            producer_instructions_per_step=prod["length"] if prod else 0,
            instructions_per_lane_step=(main["length"] * tpl +
                                        (prod["length"] if prod else 0)),
            producer_classes=prod["classes"] if prod else {},
            classes=main["classes"], mufu_per_step=main["mufu"],
            step_loops=[dict(head=hex(lp["head"]), nested=lp["nested"],
                             length=lp["length"]) for lp in loops],
            ops=main["ops"], instructions=len(ins),
            local_mem_instrs=sum(x.base in ("LDL", "STL") for x in ins),
            **resources.get(name, {})))
    return rows


def census_write(sass: str, log: str = "") -> list:
    """One row per instance (NSUB) of the single-junction write kernel
    (``csrc/llg_write.cu``, one thread per lane): its step loop's fast
    path, as ``census`` counts the LLG kernel's."""
    resources = ptxas_resources(log)
    rows = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        m = WRITE_TEMPLATE.search(name)
        if not m:
            continue
        ins = [Ins(int(a, 16), t) for a, t in INSTR.findall(part)]
        loop = fast_path(ins)[-1]
        rows.append(dict(
            nsub=int(m[1]), instructions_per_lane_step=loop["length"],
            classes=loop["classes"], mufu_per_step=loop["mufu"],
            instructions=len(ins), **resources.get(name, {})))
    return rows


def key(row: dict) -> tuple:
    return (row["thermal"], row["variation"], row["nsub"], row["tpl"],
            row["cluster"], row["produce"])


def disassemble(name: str = "llg_rk4") -> tuple:
    """(SASS, ptxas log) of the current build of ``csrc/<name>.cu``
    (``llg_rk4`` or ``llg_write``)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.llg_rk4 import BUILD_DEFINES

    defines = BUILD_DEFINES if name == "llg_rk4" else ()
    build.build(name, defines)
    lib = build.library_path(name, defines)
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return sass, build.build_log(name, defines)


def describe(row: dict) -> str:
    cls = ", ".join(f"{k} {v}" for k, v in sorted(row["classes"].items(),
                                                   key=lambda kv: -kv[1]))
    regs = (f"; {row['registers']} registers, {row.get('stack', 0)} B stack,"
            f" {row.get('spill_stores', 0)}/{row.get('spill_loads', 0)} B "
            f"spill st/ld" if "registers" in row else "")
    prod = (f" + {row['producer_instructions_per_step']} per producer step"
            if row["produce"] else "")
    return (f"THERMAL={int(row['thermal'])} VARIATION={int(row['variation'])}"
            f" NSUB={row['nsub']} TPL={row['tpl']} CLUSTER="
            f"{int(row['cluster'])} PRODUCE={int(row['produce'])}: "
            f"{row['instructions_per_thread_step']} instructions per "
            f"thread-step{prod} ({row['instructions_per_lane_step']} per "
            f"lane-step): {cls}; MUFU {row['mufu_per_step']}{regs}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", help="read this cuobjdump -sass listing "
                    "instead of building")
    ap.add_argument("--log", help="ptxas -v log to go with --sass")
    ap.add_argument("--save", help="write the disassembly here")
    args = ap.parse_args()
    if args.sass:
        sass = Path(args.sass).read_text()
        log = Path(args.log).read_text() if args.log else ""
    else:
        sass, log = disassemble()
    if args.save:
        Path(args.save).write_text(sass)
    rows = census(sass, log)
    for row in rows:
        print(describe(row), flush=True)
    print(json.dumps({"sass_census": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
