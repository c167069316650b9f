"""End-to-end training example on the PyTorch/CUDA port, the twin of
``examples/train_lm.py`` for ``src/repro_torch``.

Trains a reduced qwen2-family model for 200 steps with checkpointing and
the fault-tolerant loop (resuming from ``checkpoints/torch_example`` when a
checkpoint is there); the loss falls from ~6.7 nats as the model learns the
synthetic zipfian stream.

    python examples/torch_train_lm.py                      # GPU
    python examples/torch_train_lm.py --device cpu
    python examples/torch_train_lm.py --arch mamba2-780m --steps 50
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", default="200")
    ap.add_argument("--batch", default="8")
    ap.add_argument("--seq", default="128")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    return train_main([
        "--arch", args.arch, "--preset", "smoke",
        "--steps", args.steps, "--batch", args.batch, "--seq", args.seq,
        "--lr", "3e-3", "--log-every", "10",
        "--ckpt-dir", "checkpoints/torch_example",
    ] + (["--device", args.device] if args.device else []))


if __name__ == "__main__":
    main()
