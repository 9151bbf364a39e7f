"""Batched serving with the PyTorch/CUDA port: prefill a prompt batch and
decode greedily with Sparse-on-Dense weights (compressed storage, dense
compute), then the continuous-batching engine replaying a ragged Poisson
request trace through a paged KV cache.

Twin of ``examples/serve_decode.py``: its four ``serve.main`` runs, argument
for argument, through :mod:`repro_torch.launch.serve`.

Run on the card:  PYTHONPATH=src python examples/torch_serve_decode.py
On the CPU:  ... --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve

# run -> (heading, the reference's serve.main arguments)
RUNS = {
    "dense": ("dense weights",
              ["--arch", "llama3.2-1b", "--reduced", "--batch", "4",
               "--prompt-len", "32", "--gen", "16"]),
    "sod": ("Sparse-on-Dense (density 0.3, compressed storage)",
            ["--arch", "llama3.2-1b", "--reduced", "--batch", "4",
             "--prompt-len", "32", "--gen", "16",
             "--sod", "tiled_csc", "--density", "0.3"]),
    "hybrid": ("hybrid (zamba2: O(1) mamba state + shared-attn KV)",
               ["--arch", "zamba2-2.7b", "--reduced", "--batch", "2",
                "--prompt-len", "16", "--gen", "8"]),
    # continuous batching: staggered arrivals, mixed lengths, paged KV
    "engine": ("engine: Poisson trace, SoD weights, paged KV cache",
               ["--arch", "llama3.2-1b", "--reduced", "--engine",
                "--requests", "8", "--arrival-rate", "0.5",
                "--prompt-len", "16", "--gen", "8", "--max-slots", "4",
                "--page-size", "8",
                "--sod", "tiled_csc", "--density", "0.3", "--plan", "auto"]),
}


def main(argv=None) -> dict:
    """Serve the four runs; returns each run's summary by name."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serve.resolve_device(args.device)
    out = {}
    for run, (heading, cli) in RUNS.items():
        print(f"== {heading} ==")
        out[run] = serve.main(cli + ["--device", args.device, "--seed", str(args.seed)])
    return out


if __name__ == "__main__":
    main()
