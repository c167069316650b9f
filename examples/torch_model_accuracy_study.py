"""Model-level analog accuracy study on the PyTorch/CUDA port: the twin of
``examples/model_accuracy_study.py`` for ``src/repro_torch``.

Every linear of qwen2-0.5b (the only arch the port runs so far) goes
through the AFMTJ analog MVM — the fused fake-analog CUDA kernel for the
surface, the bit-line kernel behind the programming chain for one device
point, the XNOR kernel for the 1-bit floor — and the logits are scored
against the exact forward: KL, greedy token match, perplexity.

    python examples/torch_model_accuracy_study.py             # smoke size, GPU
    python examples/torch_model_accuracy_study.py --full      # full width, GPU
    python examples/torch_model_accuracy_study.py --device cpu  # plain versions
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.imc.analog_pipeline import AnalogConfig  # noqa: E402
from repro_torch.imc.model_analog import (_setup, model_accuracy,  # noqa: E402
                                          model_accuracy_surface)

ARCH = "qwen2-0.5b"
ADC_BITS = (4, 6, 8)
TMRS = (0.8, 5.0)          # validated ~80% and the theoretical-limit regime
CORNERS = ("tt", "ss")     # nominal + slow systematic process corner
WRITE_BERS = (0.0, 1e-2)   # perfect programming vs 1% residual write faults
BATCH, SEQ_LEN = 2, 64


def _row(label, r):
    print(f"  {label:>8} {r.tmr:5.1f} {r.corner:>6} {r.write_ber:8.0e} "
          f"{r.kl:9.4f} {r.token_match:7.3f} {r.ppl_analog:9.1f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--full", action="store_true",
                    help="full-width qwen2-0.5b instead of the smoke config")
    args = ap.parse_args()
    smoke = not args.full
    size = "smoke config" if smoke else "full width"
    print(f"=== {ARCH} ({size}, batch={BATCH}, seq={SEQ_LEN}) through the "
          f"AFMTJ MVM on the port ===")
    print(f"  {'adc_bits':>8} {'tmr':>5} {'corner':>6} {'w_ber':>8} "
          f"{'kl':>9} {'match':>7} {'ppl':>9}")
    surf = model_accuracy_surface(
        ARCH, adc_bits=ADC_BITS, tmrs=TMRS, corners=CORNERS,
        write_bers=WRITE_BERS, batch=BATCH, seq_len=SEQ_LEN, smoke=smoke,
        device=args.device)
    for r in surf:
        _row(str(r.adc_bits), r)
    print(f"  (ppl_ref {surf[0].ppl_ref:.1f})")
    state = _setup(ARCH, smoke, BATCH, SEQ_LEN, 0, args.device)
    acfg = AnalogConfig(adc_bits=8, tmr=5.0)
    with tempfile.TemporaryDirectory() as cache_dir:
        dev = model_accuracy(ARCH, acfg, mode="device", batch=BATCH,
                             seq_len=SEQ_LEN, smoke=smoke, cache_dir=cache_dir,
                             device=args.device, _setup_state=state)
    _row("device", dev)
    bnn = model_accuracy(ARCH, AnalogConfig(), mode="bnn", batch=BATCH,
                         seq_len=SEQ_LEN, smoke=smoke, device=args.device,
                         _setup_state=state)
    _row("bnn(1b)", bnn)
    print("\nKL falls with adc_bits; the device row (programming chain, bit-"
          "line kernel)\nmatches the fake row at adc 8 / TMR 5.0; bnn is the "
          "1-bit floor.")


if __name__ == "__main__":
    main()
