"""Sparse-on-Dense at the interconnect, on the PyTorch/CUDA port: compressed
weight all-gather and top-k gradient all-reduce on a (4, 2) mesh of 8 ranks.

Twin of ``examples/sod_fsdp_demo.py``.  The paper's compressed-memory trade
applied to collectives: a weight sharded over the data axis crosses the
wire as its packed TiledCSC blocks (≈ 1.5 · density of its dense bytes) and
each rank re-densifies it inside its own kernel; a gradient crosses as its
top-k coordinates.  The reference forces 8 host devices; the port starts 8
ranks (``repro_torch.launch.mesh.run_ranks``, a ``gloo`` group over a
``FileStore`` in a temporary directory), which run on the card unless
``--device cpu``.

Run on the card:  PYTHONPATH=src python examples/torch_sod_fsdp_demo.py
On the CPU (the kernel's plain version):  ... --device cpu
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile

import numpy as np
import torch

from repro_torch.core import formats, pruning
from repro_torch.kernels import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime import sod_fsdp, spmd

SHAPE, M, DENSITY, TILE, RATIO = (1024, 1024), 64, 0.25, (128, 128), 0.1
GRAD_SHAPE = (8, 65536)


def rank_main(device: str, seed: str) -> dict:
    """One rank: the compressed all-gather product and the compressed
    gradient reduce; returns what rank 0 reports."""
    mesh = mesh_mod.make_fake_mesh(device=device)
    rng = np.random.default_rng(int(seed))
    w = pruning.magnitude_prune(torch.from_numpy(
        rng.standard_normal(SHAPE, dtype=np.float32)), DENSITY).to(mesh.device)
    x = torch.from_numpy(rng.standard_normal((M, SHAPE[0]), dtype=np.float32)).to(mesh.device)
    packed = formats.pack_tiled_csc(w, tile=TILE)
    sharded = sod_fsdp.shard_packed(packed, mesh, axis="data")
    with registry.record_dispatches() as log, spmd.count_collectives() as moved:
        y = sod_fsdp.sod_fsdp_matmul(x, sharded, mesh, axis="data")
    err = (y - x @ w).abs().max().item()

    g = torch.from_numpy(rng.standard_normal(GRAD_SHAPE, dtype=np.float32))
    rows = GRAD_SHAPE[0] // mesh.shape["data"]
    d = mesh.coords["data"]
    mean, resid = sod_fsdp.compressed_grad_allreduce(
        g[d * rows:(d + 1) * rows].to(mesh.device), mesh, RATIO)
    exact = g.reshape(mesh.shape["data"], rows, -1).mean(0)
    rel = (torch.linalg.norm(mean.cpu() - exact) / torch.linalg.norm(exact)).item()
    return {"rank": mesh.rank, "device": mesh.device.type, "max_abs_err": err,
            "dense_bytes": w.numel() * 2, "compressed_bytes": packed.nbytes_compressed(),
            "payload_bytes": sum(t.numel() * t.element_size()
                                 for t in (packed.vals, packed.rows)),
            "resident_bytes": sum(t.numel() * t.element_size()
                                  for t in (sharded.vals, sharded.rows)),
            "gathered_bytes": moved.get("gather_bytes", 0),
            "dispatched": registry.dispatch_summary(log),
            "savings": sod_fsdp.collective_savings(DENSITY, ratio=RATIO),
            "grad_rel_err": rel, "residual_sum": resid.abs().sum().item()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="sod_fsdp_demo_") as work:
        ranks = mesh_mod.run_ranks(
            8, f"{pathlib.Path(__file__).resolve()}:rank_main", work,
            args=(device.type, args.seed), timeout=300)
    out = ranks[0]
    dense, comp = out["dense_bytes"], out["compressed_bytes"]
    print(f"weight all-gather: {dense:,} B dense → {comp:,} B compressed "
          f"({comp / dense:.2f}×); {out['gathered_bytes']:,} of the "
          f"{out['payload_bytes']:,} B held received a rank, "
          f"max|err|={out['max_abs_err']:.2e}")
    for line in out["dispatched"]:
        print(f"  dispatched: {line}")
    print("savings model:", out["savings"])
    print(f"grad all-reduce @ ratio {RATIO}: rel err {out['grad_rel_err']:.3f} "
          f"(residual carried to next step: {out['residual_sum']:.1f})")
    return {**out, "ranks": ranks}


if __name__ == "__main__":
    main()
