"""Quickstart of the PyTorch/CUDA port: Sparse-on-Dense in five minutes.

Twin of ``examples/quickstart.py``:

1. prune a seeded 1024 × 1024 float32 matrix (unstructured magnitude, the
   paper's setting) to density 0.3,
2. pack it into TiledCSC (16-bit values + 8-bit in-tile row indices) and
   compare the footprints (the paper's energy argument),
3. run the fused decompress + matmul CUDA kernel at M = 256 and check it
   against the dense product,
4. drop packed weights into a reduced llama3.2-1b and take one batch's loss.

Run on the card:  PYTHONPATH=src python examples/torch_quickstart.py
On the CPU (the kernel's plain version):  ... --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import formats, pruning
from repro_torch.core.sod import SoDConfig, sodify_params, tree_weight_bytes
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.kernels import ops, registry
from repro_torch.kernels import sod_matmul as sod_matmul_kernel
from repro_torch.launch.serve import resolve_device
from repro_torch.models.model import LM

SHAPE, M, DENSITY, TILE = (1024, 1024), 256, 0.3, (128, 128)
TOL = 1e-3          # max |err| against the dense float32 product (the reference's)


def weight(seed: int) -> np.ndarray:
    """The seeded dense float32 matrix that is pruned and packed."""
    return np.random.default_rng(seed).standard_normal(SHAPE, dtype=np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    launches0 = sod_matmul_kernel.launches

    with registry.count_dispatches() as dispatch:
        # -- 1/2: prune + pack ------------------------------------------------
        w = torch.from_numpy(weight(args.seed)).to(device)
        w_sparse = pruning.magnitude_prune(w, DENSITY)
        packed = formats.pack_tiled_csc(w_sparse, tile=TILE)
        summary = {"device": device.type, "density": formats.density(w_sparse),
                   "dense_bytes": packed.nbytes_dense(),
                   "compressed_bytes": packed.nbytes_compressed(),
                   "compression_ratio": packed.compression_ratio()}
        print(f"density        : {summary['density']:.3f}")
        print(f"dense bytes    : {summary['dense_bytes']:,}")
        print(f"compressed     : {summary['compressed_bytes']:,} "
              f"({summary['compression_ratio']:.2f}x, paper: 1.5·density)")

        # -- 3: fused kernel vs dense ------------------------------------------
        rng = np.random.default_rng(args.seed + 1)
        x = torch.from_numpy(rng.standard_normal((M, SHAPE[0]), dtype=np.float32)
                             ).to(device)
        y_kernel = ops.sod_matmul(x, packed, impl="cuda")
        y_dense = x @ w_sparse
        err = float((y_kernel - y_dense).abs().max())
        summary["max_abs_err"] = err
        print(f"kernel max|err|: {err:.2e}  (vs dense matmul)")
        if not err < TOL:
            raise AssertionError(f"kernel max|err| {err} not below {TOL}")

        # -- 4/5: a whole model in SoD mode ------------------------------------
        cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
            sod=SoDConfig(mode="tiled_csc", density=DENSITY, min_dim=64))
        model = LM(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = sodify_params(model.init(gen, device), cfg.sod)
        stats = tree_weight_bytes(params)
        print(f"model weights  : {stats['dense']:,} B dense → "
              f"{stats['compressed']:,} B packed ({stats['ratio']:.2f}x)")
        batch = to_device(SyntheticLMData(cfg, 2, 64, seed=0).batch(0), device)
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
        summary.update(model_bytes=stats, loss=float(loss))
        print(f"packed-model loss: {summary['loss']:.4f}")
    summary["kernel_launches"] = sod_matmul_kernel.launches - launches0
    summary["kernel_dispatch"] = dict(dispatch)
    return summary


if __name__ == "__main__":
    main()
