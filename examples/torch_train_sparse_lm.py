"""End-to-end training with the PyTorch/CUDA port: a ~100M-parameter LM with
Sparse-on-Dense weights, checkpointing and fault tolerance.

Twin of ``examples/train_sparse_lm.py``.  ``--smoke`` (the default) trains
the reduced xlstm-125m at batch 8 × seq 128; ``--full`` the real one at its
full width, batch 8 × seq 512.  Checkpoints go to a temporary directory
(removed afterwards) unless ``--ckpt-dir`` names one.

Run on the card:  PYTHONPATH=src python examples/torch_train_sparse_lm.py --full
On the CPU:  ... --smoke --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train
from repro_torch.launch.serve import resolve_device


def main(argv=None) -> dict:
    """Train; returns the training summary (without the final state)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--density", type=float, default=0.4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="sod_100m_ckpt_") as tmp:
        cli = ["--arch", "xlstm-125m",          # the ~100M-class assigned arch
               "--steps", str(args.steps),
               "--sod", "tiled_csc", "--density", str(args.density),
               "--lr", "3e-3", "--ckpt-every", "40",
               "--ckpt-dir", args.ckpt_dir or tmp, "--log-every", "10",
               "--device", args.device, "--seed", str(args.seed)]
        if args.smoke:
            cli += ["--reduced", "--batch", "8", "--seq", "128"]
        else:
            cli += ["--batch", "8", "--seq", "512"]
        summary = train.main(cli)
    summary.pop("state")
    drop = summary["first_loss"] - summary["last_loss"]
    print(f"\nloss {summary['first_loss']:.3f} → {summary['last_loss']:.3f} "
          f"(-{drop:.3f}) over {summary['steps']} steps "
          f"[sparse weights, fixed mask, density {args.density}]")
    return summary


if __name__ == "__main__":
    main()
