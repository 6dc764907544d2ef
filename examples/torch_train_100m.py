"""End-to-end driver on the PyTorch port: trains a ~100M-parameter decoder
for a few hundred steps on synthetic Markov-chain data with the production
train step, then saves its params.

The port of ``examples/train_100m.py``, with its sizes; it runs on the GPU
unless ``--device cpu`` is given, and ``--small`` trains the 4-unit,
d 256 cut of the same model.

  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] [--mode bflc]
  PYTHONPATH=src python examples/torch_train_100m.py --device cpu --small \\
      --steps 5
"""
import argparse
import os

from repro_torch.launch.train import run_lm

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "build", "examples", "torch_100m.msgpack")


def main(argv=None):
    """Trains, saves the params to ``--ckpt`` and returns the final loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mode", choices=["standard", "bflc"], default="standard")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=CKPT)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.ckpt)), exist_ok=True)
    ns = argparse.Namespace(
        steps=args.steps, batch=8, seq=256, lr=3e-4, mode=args.mode,
        cohorts=4, committee=4, small=args.small, use_all_devices=False,
        ckpt=args.ckpt, log_every=20, device=args.device,
    )
    final = run_lm(ns)
    print(f"final loss: {final:.3f}")
    return final


if __name__ == "__main__":
    main()
