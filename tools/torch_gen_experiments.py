"""Print the port's dry-run table from results/dryrun_torch/*.json (the
twin of ``tools/gen_experiments.py``): per cell the rank's argument +
temp bytes, its FLOPs (``flops_rank``) and collective bytes, and the
trace time (nothing is compiled)."""
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ORDER = ["gemma2-2b", "internlm2-20b", "qwen2-0.5b", "qwen3-8b",
         "qwen2-vl-2b", "llama4-maverick-400b-a17b", "olmoe-1b-7b",
         "seamless-m4t-large-v2", "mamba2-780m", "jamba-1.5-large-398b"]


def rows():
    out = []
    for f in sorted((REPO / "results" / "dryrun_torch").glob("*.json")):
        r = json.loads(f.read_text())
        mem = (r["memory"]["argument_size_in_bytes"]
               + r["memory"]["temp_size_in_bytes"]) / 1e9
        coll = sum(v["bytes"] for v in r["collectives"].values()) / 1e9
        out.append((r["arch"], r["shape"], r["mesh"], r["n_devices"], mem,
                    r["flops_rank"] / 1e12, coll, r["t_lower_s"]))
    out.sort(key=lambda r: (ORDER.index(r[0]), r[1], r[2]))
    return out


def main():
    print("| arch | shape | mesh | ranks | bytes/rank (GB) | TFLOPs/rank | "
          "coll GB/rank | trace (s) |")
    print("|---|---|---|---|---|---|---|---|")
    for a, s, m, n, mem, fl, c, tl in rows():
        print(f"| {a} | {s} | {m} | {n} | {mem:.2f} | {fl:.2f} | {c:.1f} | "
              f"{tl:.0f} |")


if __name__ == "__main__":
    main()
