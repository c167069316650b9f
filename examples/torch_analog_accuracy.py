"""Analog read-path accuracy sweep on the PyTorch/CUDA port: output error of
decode-step projections run through the bit-line MAC kernel
(``csrc/analog_mac.cu``), across ADC resolution and device TMR, the twin of
``examples/analog_accuracy.py`` for ``src/repro_torch``.

For each arch the decode-dominant projection (d_model -> FFN fan-out,
capped) is programmed into a differential AFMTJ crossbar
(``imc.analog_pipeline``) and driven with signed activations; the table
reports MSE / normalized MSE / cosine against the float32 product.  The
1-bit XNOR row (``csrc/xnor_gemm.cu``) is the bnn-mode floor.

The projections are drawn with a ``torch.Generator``
(``mapping.projection_draws``); the reference draws them with
``jax.random``, so the two print different samples of the same statistic
(``tools/analog_draw_spread.py`` measures their spread).  ``run(draws=)``
takes the draws from the caller instead.

    python examples/torch_analog_accuracy.py                # GPU
    python examples/torch_analog_accuracy.py --device cpu   # plain PyTorch
"""
import argparse
import contextlib
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.params import VariationSpec  # noqa: E402
from repro_torch.imc import mapping  # noqa: E402
from repro_torch.imc.mapping import (accuracy_surface,  # noqa: E402
                                     decode_projection_accuracy,
                                     decode_projection_shapes)

SWEEP_ARCHS = ("gemma2-2b", "qwen3-8b", "mamba2-780m")
ADC_BITS = (4, 6, 8)
TMRS = (0.8, 5.0)       # validated ~80% and the theoretical-limit regime
G_SIGMA = 0.05          # 5% lognormal D2D junction-resistance variation,
                        # as a VariationSpec (DESIGN.md §9)
VARIATION = VariationSpec.from_g_sigma(G_SIGMA)
CAPS = dict(cap_k=384, cap_n=256, batch=8)


def run(device=None, archs=SWEEP_ARCHS, caps=None, draws=None) -> dict:
    """The sweep's numbers: per arch the GEMV shape, ``{"adc_bits/tmr":
    (mse, nmse, cosine)}`` and the bnn row.  ``draws(seed, k, n, batch)``
    replaces ``mapping.projection_draws`` (the tests hand the reference's
    ``jax.random`` draws over)."""
    caps = dict(CAPS if caps is None else caps)
    patch = (mock.patch.object(mapping, "projection_draws", draws)
             if draws is not None else contextlib.nullcontext())
    out = {}
    with patch:
        for name in archs:
            cfg = ARCHS[name]
            k, n = decode_projection_shapes(cfg, caps["cap_k"], caps["cap_n"])
            surf = accuracy_surface(cfg, kind="afmtj", adc_bits=ADC_BITS,
                                    tmrs=TMRS, variation=VARIATION,
                                    device=device, **caps)
            bnn = decode_projection_accuracy(cfg, kind="afmtj", mode="bnn",
                                             device=device, **caps)
            out[name] = dict(
                shape=(caps["batch"], k, n),
                surface={f"{bits}/{tmr}": (r.mse, r.nmse, r.cosine)
                         for (bits, tmr), r in sorted(surf.items())},
                bnn=(bnn.mse, bnn.nmse, bnn.cosine))
    return out


def report(res: dict) -> list:
    """The lines ``examples/analog_accuracy.py`` prints, from ``run``'s
    numbers."""
    lines = ["=== Analog MVM accuracy vs ADC bits x TMR "
             f"(D2D sigma_r={G_SIGMA}, IR drop on) ===", ""]
    for name, r in res.items():
        b, k, n = r["shape"]
        lines += [f"--- {name}  (decode GEMV {b}x{k}x{n})",
                  f"  {'adc_bits':>8} {'tmr':>5} {'mse':>10} {'nmse':>10} "
                  f"{'cosine':>8}"]
        for key, (mse, nmse, cos) in r["surface"].items():
            bits, tmr = key.split("/")
            lines.append(f"  {int(bits):8d} {float(tmr):5.1f} {mse:10.2e} "
                         f"{nmse:10.2e} {cos:8.5f}")
        mse, nmse, cos = r["bnn"]
        lines += [f"  {'bnn(1b)':>8} {'-':>5} {mse:10.2e} {nmse:10.2e} "
                  f"{cos:8.5f}", ""]
    lines += ["reading the surface: nmse falls with adc_bits until the IR-drop /"
              "\nvariation floor; higher TMR widens the conductance span, so the"
              "\nsame variation costs relatively less.  The bnn row is the 1-bit"
              "\nquantization floor the paper's XNOR mode accepts for 8x density."]
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    print("\n".join(report(run(args.device))))


if __name__ == "__main__":
    main()
