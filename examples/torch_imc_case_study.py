"""IMC case study on the PyTorch/CUDA port, the twin of
``examples/imc_case_study.py`` for ``src/repro_torch``: the paper's Fig. 4
system-level evaluation and the mapping of the 10 LM architectures onto
the AFMTJ hierarchy.

The device write characterization behind both runs through the
single-junction write kernel (``csrc/llg_write.cu``).

    python examples/torch_imc_case_study.py               # GPU
    python examples/torch_imc_case_study.py --device cpu  # plain PyTorch
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.imc.evaluate import evaluate_system, summarize  # noqa: E402
from repro_torch.imc.mapping import map_all  # noqa: E402


def run(device=None) -> dict:
    """The case study's numbers: per kind the (speedup, energy saving) of
    every workload and their average, and per arch the AFMTJ speedup, AFMTJ
    energy saving and MTJ speedup of one decode token (``"map"``, what the
    example prints).  ``"decode"`` adds per arch the crossbar tiles and the
    AFMTJ and MTJ decode time [s], which scale with the arch's active
    parameter count where the printed ratios do not."""
    out = {}
    for kind in ("afmtj", "mtj"):
        res = evaluate_system(kind, device=device)
        out[kind] = {name: (r.speedup, r.energy_saving)
                     for name, r in res.items()}
        out[kind]["AVERAGE"] = summarize(res)
    maps = map_all(ARCHS, device=device)
    out["map"] = {name: (maps["afmtj"][name].speedup,
                         maps["afmtj"][name].energy_saving,
                         maps["mtj"][name].speedup) for name in ARCHS}
    out["decode"] = {name: (maps["afmtj"][name].tiles,
                            maps["afmtj"][name].t_imc,
                            maps["mtj"][name].t_imc) for name in ARCHS}
    return out


def report(res: dict) -> list:
    """The lines ``examples/imc_case_study.py`` prints, from ``run``'s
    numbers."""
    lines = ["=== Hierarchical IMC vs ARM Cortex-A72 (paper Fig. 4) ===", ""]
    for kind in ("afmtj", "mtj"):
        lines.append(f"--- {kind.upper()}-based IMC")
        for name, (sp, es) in res[kind].items():
            lines.append(f"  {name:14s} speedup {sp:6.1f}x   "
                         f"energy saving {es:6.1f}x")
        lines.append("")
    lines += ["paper: AFMTJ 17.5x / 19.9x (bnn 55.4x, mat_add 16.5x); "
              "MTJ 6x / 2.3x", "",
              "=== Beyond paper: LM decode on the AFMTJ crossbar hierarchy "
              "===", "",
              f"{'arch':28s} {'afmtj speedup':>14} {'afmtj energy':>13} "
              f"{'mtj speedup':>12}"]
    for name, (a_sp, a_es, m_sp) in res["map"].items():
        lines.append(f"{name:28s} {a_sp:13.1f}x {a_es:12.1f}x "
                     f"{m_sp:11.1f}x")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device))))


if __name__ == "__main__":
    main()
