"""Model-level analog accuracy study on the PyTorch/CUDA port: the twin of
``examples/model_accuracy_study.py`` for ``src/repro_torch``.

Every linear of the reference's sweep archs (qwen2-0.5b and gemma2-2b)
goes through the AFMTJ analog MVM — the fused fake-analog CUDA kernel for
the surface, the bit-line kernel behind the programming chain for one
device point, the XNOR kernel for the 1-bit floor — and the logits are
scored against the exact forward: KL, greedy token match, perplexity.

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

SWEEP_ARCHS = ("qwen2-0.5b", "gemma2-2b")   # the reference's sweep
ADC_BITS = (4, 6, 8)
TMRS = (0.8, 5.0)          # validated ~80% and the theoretical-limit regime
CORNERS = ("tt", "ss")     # nominal + slow systematic process corner
WRITE_BERS = (0.0, 1e-2)   # perfect programming vs 1% residual write faults
BATCH, SEQ_LEN = 2, 64


def _row(label, r):
    print(f"  {label:>8} {r.tmr:5.1f} {r.corner:>6} {r.write_ber:8.0e} "
          f"{r.kl:9.4f} {r.token_match:7.3f} {r.ppl_analog:9.1f}")


def sweep(arch: str, smoke: bool, device) -> None:
    size = "smoke config" if smoke else "full width"
    print(f"--- {arch} ({size}, batch={BATCH}, seq={SEQ_LEN})")
    print(f"  {'adc_bits':>8} {'tmr':>5} {'corner':>6} {'w_ber':>8} "
          f"{'kl':>9} {'match':>7} {'ppl':>9}")
    surf = model_accuracy_surface(
        arch, adc_bits=ADC_BITS, tmrs=TMRS, corners=CORNERS,
        write_bers=WRITE_BERS, batch=BATCH, seq_len=SEQ_LEN, smoke=smoke,
        device=device)
    for r in surf:
        _row(str(r.adc_bits), r)
    print(f"  (ppl_ref {surf[0].ppl_ref:.1f})")
    state = _setup(arch, smoke, BATCH, SEQ_LEN, 0, device)
    acfg = AnalogConfig(adc_bits=8, tmr=5.0)
    with tempfile.TemporaryDirectory() as cache_dir:
        dev = model_accuracy(arch, acfg, mode="device", batch=BATCH,
                             seq_len=SEQ_LEN, smoke=smoke, cache_dir=cache_dir,
                             device=device, _setup_state=state)
    _row("device", dev)
    bnn = model_accuracy(arch, AnalogConfig(), mode="bnn", batch=BATCH,
                         seq_len=SEQ_LEN, smoke=smoke, device=device,
                         _setup_state=state)
    _row("bnn(1b)", bnn)
    print()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--full", action="store_true",
                    help="full-width archs instead of the smoke configs")
    args = ap.parse_args()
    print("=== Model-level analog accuracy: full forwards through the AFMTJ "
          "MVM on the port ===\n")
    for arch in SWEEP_ARCHS:
        sweep(arch, not args.full, args.device)
    print("KL falls with adc_bits; the device row (programming chain, bit-"
          "line kernel)\nmatches the fake row at adc 8 / TMR 5.0; bnn is the "
          "1-bit floor.")

if __name__ == "__main__":
    main()
