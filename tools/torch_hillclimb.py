"""Perf-hillclimb driver of the port: re-trace one cell under a sharding
variant and diff its roofline terms against the recorded baseline (the
twin of ``tools/hillclimb.py``, on ``repro_torch``'s dry run).

  python tools/torch_hillclimb.py --arch qwen2-0.5b --shape train_4k \
      --env REPRO_ATTN_DP_ARCHS=qwen2-0.5b --tag attn_dp

The baseline is read from results/dryrun_torch/ (``python -m
repro_torch.launch.dryrun``); the variant lands in
results/perf_torch/<arch>__<shape>__<tag>.json.  Each variant runs in a
subprocess, so its environment knobs reach the sharding rules and leave
this process's alone.  Runs on the CPU: the dry run traces on the meta
device.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--env", action="append", default=[])
    args = ap.parse_args()

    base_f = (REPO / "results" / "dryrun_torch"
              / f"{args.arch}__{args.shape}__pod.json")
    base = json.loads(base_f.read_text())

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for kv in args.env:
        k, v = kv.split("=", 1)
        env[k] = v

    # run the variant over the baseline's file, then put the baseline back
    perf_dir = REPO / "results" / "perf_torch"
    perf_dir.mkdir(parents=True, exist_ok=True)
    bak = base_f.with_suffix(".json.bak")
    shutil.copy(base_f, bak)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             args.arch, "--shape", args.shape, "--mesh", "pod", "--force"],
            env=env, capture_output=True, text=True, timeout=3000)
        if "[ ok ]" not in r.stdout:
            print(r.stdout[-2000:])
            print(r.stderr[-3000:])
            sys.exit(1)
        variant = json.loads(base_f.read_text())
    finally:
        shutil.move(bak, base_f)

    out = perf_dir / f"{args.arch}__{args.shape}__{args.tag}.json"
    variant["variant_env"] = args.env
    out.write_text(json.dumps(variant, indent=1))

    from repro_torch.launch.roofline import analyze

    b, v = analyze(base), analyze(variant)
    print(f"{'term':12s} {'baseline':>12s} {'variant':>12s} {'delta':>8s}")
    for k in ("t_compute", "t_memory", "t_collective", "roofline_frac"):
        d = (v[k] - b[k]) / max(abs(b[k]), 1e-12) * 100
        print(f"{k:12s} {b[k]:12.4g} {v[k]:12.4g} {d:+7.1f}%")
    print(f"dominant: {b['dominant']} -> {v['dominant']}")
    cb = {k: x["bytes"] for k, x in b["collectives"].items()}
    cv = {k: x["bytes"] for k, x in v["collectives"].items()}
    print("collective bytes/dev:", {k: f"{cb[k]/1e9:.2f}->{cv[k]/1e9:.2f}GB"
                                    for k in cb if cb[k] or cv[k]})


if __name__ == "__main__":
    main()
