#!/usr/bin/env python3
"""The spread of ``examples/torch_analog_accuracy.py``'s numbers over
projection draws: the port's ``mapping.accuracy_surface`` and the bnn
projection of each arch at the example's sizes, on ``--draws`` seeds
(``decode_projection_accuracy(seed=)``), on the CPU.  Prints, per arch and
point, the mean and the relative standard deviation of nmse and cosine over
the draws, as JSON.

    PYTHONPATH=src python tools/analog_draw_spread.py [--draws 12]

The twin draws its projections with a ``torch.Generator`` and the reference
with ``jax.random``, so the two print different samples of the same
statistic; ``chip_smoke.py`` phase 11 bounds the twin's distance from the
reference's printed numbers by this spread (``ANALOG_SPREAD``).
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))

import torch_analog_accuracy as twin  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.imc.mapping import (accuracy_surface,  # noqa: E402
                                     decode_projection_accuracy)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=12)
    args = ap.parse_args()
    out = {}
    for name in twin.SWEEP_ARCHS:
        cfg = ARCHS[name]
        vals = {}
        for seed in range(args.draws):
            surf = accuracy_surface(cfg, kind="afmtj", adc_bits=twin.ADC_BITS,
                                    tmrs=twin.TMRS, variation=twin.VARIATION,
                                    seed=seed, device="cpu", **twin.CAPS)
            bnn = decode_projection_accuracy(cfg, kind="afmtj", mode="bnn",
                                             seed=seed, device="cpu",
                                             **twin.CAPS)
            for key, r in list(surf.items()) + [("bnn", bnn)]:
                vals.setdefault(str(key), []).append((r.nmse, r.cosine))
        out[name] = {}
        for key, v in vals.items():
            a = np.asarray(v)
            mean = a.mean(axis=0)
            rel = a.std(axis=0, ddof=1) / mean
            out[name][key] = dict(nmse=float(mean[0]), cosine=float(mean[1]),
                                  nmse_rel_std=float(rel[0]),
                                  cosine_rel_std=float(rel[1]))
    print(json.dumps(dict(draws=args.draws, spread=out)))


if __name__ == "__main__":
    main()
