#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it imports neither JAX nor the JAX package.
Phases, each of which raises on failure (so the script exits non-zero):

1. device — the card's name and power limit; TF32 off everywhere;
2. build  — compile every CUDA kernel of the paths (``sod_matmul``,
   ``block_matmul``, ``decompress``) from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a), all at once, and report ptxas registers and spills;
3. kernels — each kernel in each qmode (``none``, ``int8``, ``fp8``,
   ``codebook``) against its plain PyTorch version at the serving paths'
   shapes (and ragged ones), in bf16 and f32 (``decompress`` bit for bit,
   with its launch plan and, per qmode, its share of the byte bound over a
   layer, apart for the launch-bound 2048 x 512 calls and the rest;
   ``sod_matmul`` and ``block_matmul`` run twice, bit-equal across the
   calls, with their launch plans: splits, ring stages, shared memory),
   plus timings: kernel, plain version, one ``torch.matmul`` on the dense
   bf16 weight (the yardstick of the two matmuls; for ``decompress`` in
   qmode ``none``, one ``index_put_`` of the stored values at precomputed
   absolute indices into a zeroed matrix), and the bound max(bytes
   / 3.35 TB/s, operations / peak rate).  Each timed call starts with a
   clean L2: a 512 MB buffer is read, not written, so no dirty line of the
   flush drains inside the timed call; a spin kernel then keeps the card
   busy while the host enqueues the call, so no host time is timed;
4. slice  — ``repro_torch.launch.serve`` at the full width of llama3.2-1b
   and LAYERS (8) of its 16 layers, as phases 5-7 and 14 serve it (bf16,
   batch 4, prompt 32, 16 greedy tokens) in five cells: ``tiled_csc``
   and ``tiled_csc_int8`` (magnitude-pruned to density 0.3; the second is
   this slice's main path, ``--quantize int8``), ``block_csr`` and
   ``block_csr_fp8`` (block-pruned to density 0.3), and
   ``tiled_csc_codebook`` at 1 layer (the codebook is fitted on the host,
   see CODEBOOK_LAYERS).  Each cell's weights are prepared once, served
   through ``serve.main`` with its kernel's launch count read around the
   run, then its prefill is held against the same weights densified
   (through ``ops.decompress``) and run through the dense matmul;
5. profile — one decode step of four cells under ``torch.profiler``: device
   time by kernel, the device's idle share, and the calls of a separate
   split-K reduce kernel (none in any cell: both matmul kernels reduce
   their splits inside their launch); and the tied LM head's GEMM with
   f32 output against the same GEMM with bf16 output;
6. engine — ``serve.py --engine`` (the continuous-batching engine) at full
   width, bf16, on the weights phase 4 packed, over ``poisson_trace(8, 0.5,
   max_prompt=64, max_new=16)`` (prompts of 32-64 tokens), 4 slots, 16-token
   pages, in three runs: ``tiled_csc`` with the prompt prefilled at
   admission in one forward, ``tiled_csc`` with 16-token chunks, and
   ``block_csr`` fused.  Each run must complete every request, emit for
   every request the tokens of the port's ``static_generate`` on the card
   bit for bit, launch its cell's kernel (and not the other), and keep its
   logits finite; it prints throughput, warmup, latency, wall ms a step and
   the launch plans' K splits at the prefill shapes.  One steady engine
   step of the first run is profiled for its device time and idle share.
   Four more runs drive the engine's other stages, each on the same packed
   weights with 16-token pages, 4 slots and ``max_len`` 80 (FEATURE_RUNS):
   ``tiled_csc_stress`` (preemption with page swapping and prefix sharing on
   a shared-prefix trace and a pool of 8 pages), ``tiled_csc_spec2``
   (``serve --engine --spec-decode 2 --draft-sparsity 0.88``: a draft of the
   same raw weights at density 0.12), ``block_csr_stress_spec`` (every
   feature at once, a block-pruned ``block_csr`` draft at 0.12, a starved
   pool) and ``tiled_csc_cache`` (two identical epochs of a repeated prompt
   through the prefix cache: a 3-page budget and a disk directory).  Each
   holds every request's tokens against ``static_generate`` bit for bit,
   its kernel launched (both tiers counted apart) and the other not, finite
   logits, a clean pool afterwards and its features' counters (preemptions
   of the youngest decoding sequence, swap-ins, shared pages, spec windows,
   rollbacks, no fresh prompt page in epoch 2, disk demotions, the cache-off
   run's tokens).  Last, one spec window (3 draft decode steps and the
   verify) is profiled beside 3 plain decode steps;
7. plan — the planner and the tuned dispatch at full width, bf16, on
   phase 4's raw weights (``--seed 0``), with a fresh tuning cache in a
   temporary directory, in six runs of ``serve`` (PLAN_RUNS):
   ``plan_tiled_csc`` (``--plan auto --autotune --tuning-cache T --plan-json
   P``: packs bit-equal to phase 4's tiled_csc, its prefill through phase
   4's densified check, the autotune stats and each layout's winner beside
   the untuned launch), ``plan_replay`` (``--plan P`` on the warm cache: no
   new measurement, the same packs and tokens), ``plan_block_csr`` (``--plan
   auto --autotune``: only ``cuda_block`` dispatched), ``plan_quantize_auto``
   (``--plan auto --quantize auto``: each entry's qmode and drift, the
   kernel launched in each chosen qmode, the densified check),
   ``plan_engine`` (``--engine --plan P`` on the warm cache over phase 6's
   trace: every request equals ``static_generate`` under the same plan and
   cache bit for bit, so tuning kept a row's sums independent of M) and
   ``plan_spec`` (``--engine --spec-decode 2 --plan auto`` without
   ``--draft-sparsity``: the planner's draft density and its diagnostics,
   every request bit-equal to ``static_generate``).  Every run fails if its
   dispatch log shows the plain version (``torch_oracle``) on the card;
8. train — training at full width and TRAIN_LAYERS (4) of llama's 16
   layers, bf16, batch 8 × seq 128 (M = 1024 rows a matmul), after the
   serving weights are freed.  First each matmul
   kernel's ``autograd.Function`` (``kernels/vjp.py``) in each qmode at
   every K×N of the model: output, dx and the packed float leaves'
   gradients against autograd over ``kernels/ref.py`` on the card, within
   KERNEL_TOL (fp8 codes' gradients within one e4m3 rounding), exact 0 at
   padding.  Then three ``repro_torch.launch.train`` runs (TRAIN_RUNS),
   each with its checkpoints in a temporary directory deleted after it:
   ``train_tiled_csc`` (12 steps), ``train_block_csr`` (6) and
   ``train_tiled_csc_int8`` (4), gated on finite losses and gradient
   norms, a falling loss, integer leaves bit-equal to the initial pack,
   padding exactly 0, only the format's CUDA impl dispatched, 2 × 28
   matmul launches a step (the remat recompute) and 28 ``decompress``
   launches a step for a TiledCSC (the backward's re-densify), and the
   scales moved under int8; one steady ``train_tiled_csc`` step is
   profiled (device time by kernel and operator class, idle share, tok/s,
   peak memory).  Last, ``train_resume``: the reduced model 12 steps with
   a checkpoint every 5, then twice ``--resume --steps 16`` from copies of
   its directory, losses and states bit-equal;
9. dense_family — the rest of the dense family at full width.  First each
   kernel at the shapes the family adds (FAMILY_SHAPES: the untied heads of
   internlm2-1.8b and yi-34b with float32 out, gemma2-27b's and yi-34b's
   large-K ``w_down``, gemma2's 4096-wide ``wo``), ``sod_matmul`` in qmode
   none and int8, ``block_matmul`` in none, ``decompress`` in none and
   int8, at M = 4 and 128: against its plain version, two calls bit-equal,
   its launch plan, and timed beside its plain version, ``torch.matmul``
   and its bound.  Then four static cells through ``serve.main``
   (FAMILY_CELLS): ``internlm2_tiled_csc`` (4 of 24 layers, its head packed;
   (4 · 7 + 1) × 17 launches; one decode step and the head alone
   profiled), ``internlm2_tiled_csc_int8`` (the same raw weights, int8),
   ``gemma2_tiled_csc`` (4 of 46 layers; every logit within the final
   soft-cap of 30) and ``yi_block_csr`` (4 of 60 layers, block-pruned; the
   head through ``block_matmul``), each against its densified weights (the
   head included); engine runs on their weights (FAMILY_ENGINE_RUNS: fused
   and ``--spec-decode 2`` for internlm2 and gemma2, fused for yi), every
   request equal to ``static_generate`` bit for bit and an untied head run
   at 1, 4 and 4 × 3 rows; and ``train_internlm2`` (4 layers, 4 steps,
   the head's gradient at M = 1024 against the plain version first, one
   step profiled);
10. moe_family — the MoE family at full width and MOE_LAYERS (4) of its
   24 layers, served through
   the SoD kernels under a pack plan without routed-expert entries (the
   routed experts stay dense: packing them is the reference's fault R4).
   First each kernel at the shapes the family adds (MOE_SHAPES: granite's
   1024 × 1024 and 1024 × 512 attention, qwen's shared expert and its
   2048 × 151,936 head at f32 out), at M = 4 and 128, as phase 9 runs them.
   Then three static cells (MOE_CELLS): ``granite_moe_tiled_csc``
   (granite-moe-1b-a400m: 32 experts top-8, tied head; 4 · 4 · 17 = 272
   launches), ``granite_moe_block_csr`` (block-pruned, 272
   ``block_matmul``) and ``qwen2_moe_tiled_csc`` (qwen2-moe-a2.7b: 60
   experts padded to 64, top-4, the shared expert and untied head packed;
   (4 · 7 + 1) · 17 = 493 launches).  Each builds its plan
   with ``runtime/planner.build_plan`` on the seeded raw weights (the
   routed experts' entries planned with lead (4, 1, E)), drops the routed
   entries (``moe.without_routed``), saves it and serves with ``--plan
   P``, gated on its kernel's launches only, no ``torch_oracle`` dispatch,
   finite logits and prefill logits within LOGIT_TOL of the densified
   weights.  Engine runs on those weights and plans (MOE_ENGINE_RUNS:
   granite fused and with 16-token chunks, qwen fused) hold every request
   against ``static_generate`` bit for bit, with a clean pool; one qwen
   decode step is profiled (device ms by kernel and by class: the SoD
   kernels, the routed experts' products, the dispatch, attention; the
   idle share); ``train_granite`` trains 4 layers under its own plan,
   batch 8 × seq 128, 4 steps (finite losses, gradient norms and aux
   losses, every aux above 0, 2 × 16 ``sod_matmul`` and 16
   ``decompress`` launches a step, only ``cuda_fused`` dispatched);
11. recurrent_family — the recurrent families at full width, through the
   SoD kernels (every Mamba2, mLSTM, shared-block and head projection
   packed; Mamba2's w_b, w_c, w_dt, mLSTM's w_if and sLSTM's gates dense,
   as the reference).  First each kernel at the shapes the families add
   (RECURRENT_SHAPES: zamba2's 2560 × 5120, 5120 × 2560 and shared MLP,
   both heads at f32 out, xlstm's 1536 × 1536 and 768 × 3072), at M = 4
   and 128, as phase 9 runs them.  Then three static cells (batch 4,
   prompt 32, 16 tokens, density 0.3): ``zamba2_tiled_csc`` (6 of 54
   layers: 6 Mamba2 blocks, the shared block applied once, untied head),
   ``zamba2_block_csr`` (block-pruned, 6 layers) and ``xlstm_tiled_csc``
   (4 of 12 layers), each prompt replayed through the decode step, so a cell
   launches its kernel _recurrent_per_step × 48 times ((6 · 3 + 7 + 1) ×
   48 = 1,248 for zamba2, (3 · 5 + 1) × 48 = 768 for xlstm) and
   no other, with no ``torch_oracle`` dispatch, finite logits and the
   last prompt position's logits within LOGIT_TOL of the densified
   weights' (both stepped); zamba2's chunked SSD forward (``LM.apply``)
   held against its stepped decode at that position within LOGIT_TOL; one
   zamba2 decode step profiled by class (SoD kernels, scan and conv, the
   dense GEMMs, attention, the head alone); engine runs in the slot
   regime on zamba2's and xlstm's weights over phase 6's trace, every
   request equal to ``static_generate`` bit for bit; ``train_xlstm`` (4
   layers) and ``train_zamba2`` (6 layers) at full width (batch 8 × seq
   128, 4 steps,
   remat: finite losses and gradient norms, (2 · (per step - 1) + 1)
   ``sod_matmul`` and per-step ``decompress`` launches a step, only
   ``cuda_fused`` dispatched), one step of each profiled;
12. frontends — the VLM and audio families at full width, through the SoD
   kernels (every projection and the untied head packed; pixtral's
   ``patch_proj`` and the embeddings dense, as the reference).  First each
   kernel at the shapes they add (FRONTEND_SHAPES: pixtral's w_gate and
   w_down, both heads at f32 out, musicgen's 1536 × 8192 over its 4
   codebooks), at M = 4 and 128, as phase 9 runs them.  Then three static
   cells at a depth cut (FRONTEND_CELLS, density 0.3, 16 tokens):
   ``pixtral_tiled_csc`` (8 of 40 layers, batch 2, 1024 patches + 512 text
   tokens), ``musicgen_tiled_csc`` and ``musicgen_block_csr`` (12 of 48
   layers, block-pruned; batch 4, prompt 32), each launching its kernel
   (layers · 7 + 1) × 17 times ((8 · 7 + 1) × 17 = 969 for pixtral, (12 ·
   7 + 1) × 17 = 1,445 for musicgen) and no other, with no ``torch_oracle`` dispatch, finite logits,
   musicgen's ids (B, 16, 4) below 2048, and the last prompt position's
   logits within LOGIT_TOL of the densified weights' (each prefill timed);
   pixtral's decode at its true position (n_patches + text) held against
   the full forward within LOGIT_TOL (static serving decodes at the text's
   length, the reference's fault R5); one decode step of pixtral and of
   musicgen profiled by class (SoD kernels, attention, the head alone, the
   rest); ``train_musicgen`` (8 layers, batch 8 × seq 128) and
   ``train_pixtral`` (2 layers, batch 1 × seq 1536, the loss on the text),
   4 steps each: the frontend leaf's gradient finite and not 0, finite
   losses and gradient norms, (2 · layers · 7 + 1) ``sod_matmul`` and
   (layers · 7 + 1) ``decompress`` launches a step, only ``cuda_fused``
   dispatched, one step profiled;
13. paper — the twins of three of the reference's examples
   (``examples/torch_*.py``), in-process on the card.  ``torch_quickstart``:
   a seeded 1024 × 1024 float32 matrix magnitude-pruned to 0.3 and packed
   (its bytes and ratio printed), the forced ``sod_matmul`` at M = 256
   against ``x @ w_sparse`` (max |err| < 1e-3), one batch's loss of the
   reduced llama3.2-1b (1 + 2 · 7 launches, nothing else, no
   ``torch_oracle``).  ``torch_serve_decode``: its four ``serve.main`` runs
   (llama dense, llama tiled_csc 0.3, zamba2 dense, the engine with ``--plan
   auto``), each run's launches derived from its config (0, 2 · 7 × 17, 0,
   and the engine's packed operands × its step calls), finite logits, every
   engine request equal to ``static_generate`` under the plan bit for bit.
   ``torch_train_sparse_lm --full --steps 2``: xlstm-125m at full width,
   batch 8 × seq 512, phase 11's launches a step, finite losses, only
   ``cuda_fused``; the seconds a step and the peak memory printed.  Last,
   ``H100_SXM`` beside the card's properties, and this script, the probe
   and the autotuner gated on reading it;
14. mesh — the distributed runtime's execution layer: four ranks on the
   one card (``launch.mesh.run_ranks``), a (2, 2) (data, model) mesh over
   ``gloo`` (NCCL refuses two ranks on one device), every rank on the
   kernels the build phase built.  Per cell (MESH_CELLS: llama3.2-1b at
   full width, bf16, density 0.3, ``mesh_tiled_csc`` magnitude- and
   ``mesh_block_csr`` block-pruned) each rank packs phase 4's weights,
   keeps its resident blocks (``runtime.sharding.place``), runs one layer's
   seven projections under each of the five plan kinds at M = 4 and 128
   against the single-process kernel (KERNEL_TOL; only the cell's CUDA impl
   dispatched, under mesh keys; a gather plan receiving exactly the
   compressed payload less its own block, beside the napkin of
   ``collective_savings``), then at MESH_SERVE_LAYERS (8) layers prefill
   and 8 decode steps through the step builders with ``mesh=`` on its
   resident blocks, the partitioned program (each rank its rows, its
   heads, MLP columns and vocabulary; the KV cache, its length rounded up
   to a multiple of ``model`` and given to the decode step, its rows and
   its block of positions of every KV head, the softmax combined across
   ranks), fed the single-process run's tokens: decode logits within
   LOGIT_TOL of one process's, the greedy agreement printed, (8 · 7) × 9 =
   504 launches a rank, the KV leaf's layout, the mesh run's seconds and a
   rank's peak memory beside the whole-rows program's (WHOLE_ROWS);
   ``mesh_block_csr`` is served again with no length given, at the
   unrounded 41 positions (the cache every position of the rank's KV
   heads).  ``mesh_long``: llama3.2-1b at 8 layers, batch 4, 8 greedy
   steps at the last positions of a seeded 32,768-position cache (v with
   an offset a 4,096 positions), each rank on its 2 rows × 16,384
   positions, against one process: logits within LOGIT_TOL, 448 launches,
   a quarter of the cache a rank, and a control (one process with v zero
   on one rank's block) that must move the logits past LOGIT_TOL.  Last,
   ``loss_and_grads`` at full width and 4 layers,
   batch 4 × 128, against one process (the loss, and every gradient after
   ``runtime.sharding.unplace``) with each rank's peak memory and step
   seconds beside the whole-rows program's.  The phase prints its seconds by part (start,
   pack, ops, serve, long, grads);
15. the rest of the distributed runtime, in phase 14's ranks after its
   parts: the engine on the mesh (``Engine(mesh=)``, llama3.2-1b tiled_csc
   at 4 layers, four requests of 8 tokens, every one bit-equal to the mesh
   static decode); qwen2-moe-a2.7b at full width and 4 layers under a plan
   without routed entries, its routed experts through the all-to-all over
   ``model`` (prefill 4 × 32 and 8 decode steps against one process's
   capacity dispatch in 4 blocks, the tokens routed as the one process
   chose: logits within LOGIT_TOL, the all-to-all count above 0 on every
   rank, (4 · 7 + 1) × 9 launches); the recurrent families
   (``mesh_recurrent``, RECURRENT_MESH_CELLS: zamba2-2.7b at 6 layers, 40
   Mamba2 and 16 attention heads a rank, and xlstm-125m at 4 layers, 2
   mLSTM heads a rank; full width, tiled_csc, each rank packing alone), a
   prompt of 4 × 32 stepped through the partitioned decode step and 8
   decode steps against one process (logits within LOGIT_TOL, greedy
   agreement, (6 · 3 + 7 + 1) and (3 · 5 + 1) launches a step × 40 steps),
   then ``loss_and_grads`` against one process (4 × 128, xlstm 4 × 64:
   the loss and every gradient after ``unplace``); the elastic re-mesh (two train steps
   on (2, 2) at 4 layers, the whole state saved, ranks 2 and 3 lost, the
   survivors on (1, 2) restore and take a step whose loss is within
   ELASTIC_LOSS_TOL of one process's on the same checkpoint, and whose
   whole state after it is within ELASTIC_STATE_TOL leaf by leaf).  Beside the
   ranks the host runs the dry-run cells (DRY_CELL, DRY_MOE_CELL and
   DRY_HYBRID_CELL, on meta tensors: status ok, nothing launched, the
   card's kernel dispatched) and prints their flops, argument and peak
   bytes a rank, collective bytes by kind and dispatches beside the
   reference's record (DRY_REFERENCE) or the whole-rows program's, gated
   on the peak below DRY_PEAK_LIMIT and the flops within DRY_FLOPS_BAND
   of the reference's (at most DRY_MOE_FLOPS_LIMIT and
   DRY_HYBRID_FLOPS_LIMIT for the others).
   The phase prints its seconds by part (engine, moe, frontends,
   recurrent, elastic, dryrun).

Each phase prints its seconds.  The last lines are the ``nvidia-smi``
name/power line, one JSON object with the kernels' numbers (one entry per
kernel and qmode, with the launches and registry dispatches of phase 7's
runs, the launches and gradient error of phase 8, and phase 9's launches
by cell and its shapes' times, and phases 10 to 12 the same way), and
``{"ok": true, "device": {...}}``.  The whole run reads and
writes a tuning cache of its own in a temporary directory, so phases 4-6
dispatch on a cold cache (the untuned launches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.formats import (BlockCSR, TiledCSC,  # noqa: E402
                                      pack_block_csr, pack_tiled_csc,
                                      quantize_packed)
from repro_torch.core.pruning import block_prune, magnitude_prune  # noqa: E402
from repro_torch.core.topology import H100_SXM  # noqa: E402
from repro_torch.core import sod as sod_mod  # noqa: E402
from repro_torch.core.sod import SoDConfig  # noqa: E402
from repro_torch.kernels import block_matmul as bmm  # noqa: E402
from repro_torch.kernels import autotune, build, ops, ref, registry, timing  # noqa: E402
from repro_torch.kernels import decompress as dk  # noqa: E402
from repro_torch.kernels import sod_matmul as sm  # noqa: E402
from repro_torch.kernels import vjp  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData, to_device  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import state_dist  # noqa: E402
from repro_torch.runtime import planner  # noqa: E402
from repro_torch.serving import (Engine, bucket_len, poisson_trace,  # noqa: E402
                                 repeated_prompt_trace, shared_prefix_trace,
                                 mesh_static_generate, static_generate,
                                 stress_spec_trace)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit),
# from the port's one chip spec; ChipSpec has no float32 field, so that rate
# stays here.
HBM_BYTES_PER_S = H100_SXM.hbm_bandwidth
PEAK_OPS_PER_S = {torch.bfloat16: H100_SXM.peak_bf16_flops,   # tensor cores, bf16
                  torch.float32: 67e12}     # float32 outside the tensor cores
# Kernel vs plain version, as a fraction of the plain output's largest
# magnitude: float32 sums in another order (1e-4); bf16 may round the output
# one bf16 step (2**-8 relative) apart.  decompress: bit-equal.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}
# Kernel path vs dense torch.matmul path, prefill logits at full width, as a
# fraction of the dense logits' largest magnitude: both round every
# projection's output and the residual stream to bf16, in different places
# of the f32 sums, through 16 layers.
LOGIT_TOL = 0.05

DENSITY = 0.3
# phases 4-7 at 8 of llama's 16 layers (phase 14 serves the same depth), for
# the script's time: the same phases took 1.3-1.7x as long on one H100 as
# on another, and a run of the script went over its 1,200 s
LAYERS = 8
# The codebook cell's depth: its shared-value tables are fitted on the host
# with numpy (Lloyd k-means, as the reference), about 25 s a full-width layer
# on one CPU core, so the cell runs at full width but 1 layer (2 until the
# frontends' phase 12 needed the time).
CODEBOOK_LAYERS = 1
QMODES = ("int8", "fp8", "codebook")
BASE_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "32",
             "--gen", "16", "--seed", "0", "--device", "cuda"]
TILED_ARGV = BASE_ARGV + ["--sod", "tiled_csc", "--density", str(DENSITY)]


def _block_sod(qmode: str = "none") -> SoDConfig:
    """block_csr with block pruning, as the JAX package's serving bench runs
    that format (the CLI's --sod block_csr keeps magnitude pruning)."""
    return SoDConfig(mode="block_csr", density=DENSITY, prune_method="block",
                     min_dim=64, qmode=qmode)


# name -> argv, caller's SoDConfig, kernel, qmode, layers
CELLS = {
    "tiled_csc": (TILED_ARGV, None, "sod_matmul", "none", LAYERS),
    "block_csr": (BASE_ARGV, _block_sod(), "block_matmul", "none", LAYERS),
    "tiled_csc_int8": (TILED_ARGV + ["--quantize", "int8"], None, "sod_matmul",
                       "int8", LAYERS),
    "block_csr_fp8": (BASE_ARGV, _block_sod("fp8"), "block_matmul", "fp8", LAYERS),
    "tiled_csc_codebook": (TILED_ARGV + ["--quantize", "codebook"], None,
                           "sod_matmul", "codebook", CODEBOOK_LAYERS),
}
UNQUANTIZED = {"sod_matmul": "tiled_csc", "block_matmul": "block_csr"}
PROFILED = ("tiled_csc", "block_csr", "tiled_csc_int8", "block_csr_fp8")
# (K, N) of the path's projections, and how many of each a layer has
PATH_SHAPES = {(2048, 2048): ("wq+wo", 2), (2048, 512): ("wk+wv", 2),
               (2048, 8192): ("w_gate+w_up", 2), (8192, 2048): ("w_down", 1)}
PATH_M = {"decode": 4, "prefill": 128}
RAGGED = [((300, 260), 77), ((2048, 512), 77), ((8192, 2048), 5)]
REPS = 25
PLANS = {"sod_matmul": sm.plan_of, "block_matmul": bmm.plan_of}
COUNTERS = {"sod_matmul": sm, "block_matmul": bmm, "decompress": dk}
SOURCES = {"sod_matmul": ("src/repro_torch/kernels/csrc/sod_matmul.cu",
                          "src/repro/kernels/sod_matmul.py:135"),
           "block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                            "src/repro/kernels/block_matmul.py:99"),
           "decompress": ("src/repro_torch/kernels/csrc/decompress.cu",
                          "src/repro/kernels/decompress.py:39")}


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def reset_counts() -> None:
    for mod in COUNTERS.values():
        mod.launches = 0


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": smi, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        log({"phase": "ptxas", "kernel": name, "functions": _ptxas(text)})
    log({"phase": "build", "seconds": secs, "kernels": sorted(logs),
         "dir": str(build.build_dir())})


def _ptxas(text: str) -> list[dict]:
    """Registers and spill bytes of each compiled function, from nvcc's
    ``-Xptxas -v`` report (mangled names)."""
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = {"fn": m.group(1)}
            out.append(fn)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            fn["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["regs"] = int(m.group(1))
    return out


def _weights(k: int, n: int, m: int, dtype, seed: int, block: bool):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = torch.randn(k, n, generator=g, device="cuda").to(dtype)
    w = block_prune(w, DENSITY) if block else magnitude_prune(w, DENSITY)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    return x, w


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of one call over REPS calls, on the clean-L2
    yardstick of :mod:`repro_torch.kernels.timing`."""
    return timing.device_ms(fn, flush, REPS)


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _bound(nbytes: int, n_ops: int, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _work(name: str, x: torch.Tensor, p, y: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) the function needs on these inputs: each input
    read once (the quantization side band included) and the output ``y``
    written once; a matmul does 2 operations per stored value and row of x,
    counting only what is stored (the real slots of a TiledCSC, the
    tile_nnz sub-blocks of a BlockCSR, with their ids)."""
    side = _nbytes(p.scale) + _nbytes(p.codebook)
    if name == "decompress":   # every slot is read; the dense matrix written
        return _nbytes(p.vals) + _nbytes(p.rows) + side + _nbytes(y), 0
    m = x.shape[0]
    if name == "sod_matmul":
        return (_nbytes(x) + _nbytes(p.vals) + _nbytes(p.rows) + side + _nbytes(y),
                2 * m * int((p.rows >= 0).sum()))
    stored = int(p.tile_nnz.sum()) * p.br * p.tile[1]
    return (_nbytes(x) + stored * p.block_vals.element_size()
            + int(p.tile_nnz.sum()) * 4 + _nbytes(p.tile_nnz) + side + _nbytes(y),
            2 * m * stored)


def _scatter_args(p) -> tuple:
    """((rows, cols), vals) of a TiledCSC's real slots at their absolute
    positions: the arguments of one ``index_put_`` that densifies it."""
    kt, nt, cap, bn = p.vals.shape
    bk = p.tile[0]
    r = p.rows.long()
    real = r >= 0
    rows = r + bk * torch.arange(kt, device=r.device).view(kt, 1, 1, 1)
    cols = (bn * torch.arange(nt, device=r.device).view(1, nt, 1, 1)
            + torch.arange(bn, device=r.device).view(1, 1, 1, bn)).expand_as(r)
    return (rows[real], cols[real]), p.vals[real]


def _kernel_cases():
    """(kernel, qmode, K, N, M, case, dtype) of phase 3: qmode none in bf16
    and f32 as before; each quantized qmode at the path shapes in bf16 and
    one ragged case in f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("sod_matmul", "block_matmul"):
            cases += [(name, "none", k, n, m, tag, dtype) for (k, n) in PATH_SHAPES
                      for tag, m in PATH_M.items()]
            cases += [(name, "none", k, n, m, "ragged", dtype) for (k, n), m in RAGGED]
        cases.append(("block_matmul", "none", 8192, 2048, 4, "zero_tile_row", dtype))
        cases += [("decompress", "none", k, n, 1, "path", dtype) for (k, n) in PATH_SHAPES]
        cases.append(("decompress", "none", 300, 260, 1, "ragged", dtype))
    for q in QMODES:
        for name in ("sod_matmul", "block_matmul"):
            cases += [(name, q, k, n, m, tag, torch.bfloat16) for (k, n) in PATH_SHAPES
                      for tag, m in PATH_M.items()]
            cases.append((name, q, 300, 260, 77, "ragged", torch.float32))
        cases += [("decompress", q, k, n, 1, "path", torch.bfloat16) for (k, n) in PATH_SHAPES]
    return cases


def _quantized_packs(cases) -> dict:
    """One quantized operand per (format, K, N, qmode) of the phase-3 cases,
    made from a bf16 weight and reused across M and the activations' dtype.
    The codebook fits run on the host in numpy, so they run in threads."""
    shapes = {("block" if name == "block_matmul" else "tiled", k, n)
              for name, q, k, n, *_ in cases if q != "none"}
    base = {}
    for i, (fmt, k, n) in enumerate(sorted(shapes)):
        _, w = _weights(k, n, 1, torch.bfloat16, 1000 + i, block=fmt == "block")
        base[(fmt, k, n)] = pack_block_csr(w) if fmt == "block" else pack_tiled_csc(w)
    torch.cuda.synchronize()
    jobs = [(key, q) for key in sorted(base) for q in QMODES]
    with ThreadPoolExecutor(max_workers=8) as pool:
        packs = pool.map(lambda job: quantize_packed(base[job[0]], job[1]), jobs)
        return {(*key, q): p for (key, q), p in zip(jobs, packs)}


def _run_case(name, qmode, k, n, m, tag, dtype, seed, qpacks):
    """(x, packed, kernel fn, plain fn) of one phase-3 case."""
    block = name == "block_matmul"
    if qmode == "none":
        x, w = _weights(k, n, m, dtype, seed, block)
        if tag == "zero_tile_row":      # a macro-tile row with tile_nnz == 0
            w[2048:2176] = 0
        p = pack_block_csr(w) if block else pack_tiled_csc(w)
    else:
        p = qpacks[("block" if block else "tiled", k, n, qmode)]
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    if name == "block_matmul":
        return x, p, lambda: bmm.block_matmul(x, p), lambda: ref.block_matmul_ref(x, p)
    if name == "sod_matmul":
        return x, p, lambda: sm.sod_matmul(x, p), lambda: ref.sod_matmul_ref(x, p)
    return x, p, lambda: dk.decompress(p), lambda: ref.decompress_tiled_ref(p)


def phase_kernels() -> dict:
    flush = timing.flush_buffer()
    cases = _kernel_cases()
    t0 = time.perf_counter()
    qpacks = _quantized_packs(cases)
    log({"phase": "kernels", "quantized_packs_s": time.perf_counter() - t0,
         "packs": len(qpacks)})
    max_err: dict[tuple, float] = {}
    launches: dict[tuple, int] = {}
    timed: dict[tuple, dict] = {}
    for i, (name, qmode, k, n, m, tag, dtype) in enumerate(cases):
        x, p, kernel, plain = _run_case(name, qmode, k, n, m, tag, dtype, i, qpacks)
        reset_counts()
        y, yr = kernel(), plain()
        torch.cuda.synchronize()
        row = {"phase": "kernels", "kernel": name, "qmode": qmode, "K": k, "N": n,
               "M": m, "case": tag, "dtype": str(dtype).split(".")[-1]}
        if name == "decompress":
            ok = torch.equal(y, yr) and y.dtype == yr.dtype
            row.update(cap=p.cap, out_dtype=str(y.dtype).split(".")[-1], bit_equal=ok)
            err = 0.0 if ok else (y.float() - yr.float()).abs().max().item()
        else:
            err = (y.float() - yr.float()).abs().max().item()
            tol = KERNEL_TOL[dtype] * yr.float().abs().max().item()
            ok = err <= tol
            row.update(max_abs_err=err, tol=tol)
            if name == "block_matmul":
                row.update(bcap=p.bcap, stored_share=int(p.tile_nnz.sum())
                           / (p.tile_nnz.numel() * (p.tile[0] // p.br)),
                           empty_tiles=int((p.tile_nnz == 0).sum()))
            else:
                row.update(cap=p.cap)
            y2 = kernel()               # a second call: bit-equal, however it splits
            torch.cuda.synchronize()
            plan = PLANS[name](x, p)
            row.update(bm=plan.bm, m_groups=plan.m_groups, splits=plan.splits,
                       stages=plan.stages,
                       x_tiles=plan.x_tiles, smem_bytes=plan.smem_bytes,
                       ctas_per_sm=plan.ctas_per_sm,
                       bit_equal_across_calls=torch.equal(y, y2))
            ok = ok and row["bit_equal_across_calls"]
        if not ok:
            log(row)
            raise AssertionError(f"{name}[{qmode}] disagrees with its plain "
                                 f"version at {row}")
        key = (name, qmode)
        max_err[key] = max(max_err.get(key, 0.0), err)
        if tag in ("decode", "prefill", "path") and dtype == torch.bfloat16:
            row["kernel_ms"] = _time_ms(kernel, flush)
            row["plain_ms"] = _time_ms(plain, flush)
            if name == "decompress" and qmode == "none":
                # one scatter of the stored values at precomputed absolute
                # indices into a zeroed dense matrix
                scatter = _scatter_args(p)
                row["library_ms"] = _time_ms(lambda: torch.zeros(
                    p.shape, dtype=p.vals.dtype, device="cuda").index_put_(*scatter),
                    flush)
            elif name == "decompress":
                row["library_ms"] = None   # dequantizing is a second call
            else:
                dense = p.to_dense().to(x.dtype)
                row["library_ms"] = _time_ms(lambda: torch.matmul(x, dense), flush)
            row["bound_ms"], row["bound_by"] = _bound(*_work(name, x, p, y), dtype)
            if name == "decompress":
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                row["plan"] = dataclasses.asdict(dk.plan_of(p, y.dtype))
            row["launches_per_forward"] = LAYERS * PATH_SHAPES[(k, n)][1]
            row["projections"] = PATH_SHAPES[(k, n)][0]
            timed[(name, qmode, k, n, tag)] = row
        launches[key] = launches.get(key, 0) + COUNTERS[name].launches
        log(row)
    for qmode in ("none", *QMODES):
        log(_decompress_share(qmode, timed))
    return {"max_err": max_err, "timed": timed, "launches": launches, "qpacks": qpacks}


def _decompress_share(qmode: str, timed: dict) -> dict:
    """decompress's share of its byte bound over one layer's 7 projections
    in one qmode, and apart for the 2048 x 512 calls (wk, wv: about 1 µs of
    bytes each, so launch-bound) and the rest."""
    rows = [(row, PATH_SHAPES[(k, n)][1]) for (name, q, k, n, _), row in timed.items()
            if name == "decompress" and q == qmode]

    def layer(small: bool | None) -> tuple[float, float]:
        picked = [(r, c) for r, c in rows
                  if small is None or ((r["K"], r["N"]) == (2048, 512)) == small]
        return (sum(r["kernel_ms"] * c for r, c in picked),
                sum(r["bound_ms"] * c for r, c in picked))

    (ms, bound), (ms_small, bound_small), (ms_rest, bound_rest) = (
        layer(None), layer(True), layer(False))
    return {"phase": "kernels", "kernel": "decompress", "qmode": qmode,
            "layer_ms": ms, "layer_bound_ms": bound, "share_of_bound": bound / ms,
            "share_wk_wv": bound_small / ms_small, "share_rest": bound_rest / ms_rest}


def _densify(tree):
    """The same tree with every packed leaf made dense through ops.decompress."""
    if isinstance(tree, dict):
        return {k: _densify(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_densify(v) for v in tree]
    return ops.decompress(tree)


def _packed_paths(tree: dict, prefix: str = "") -> list[str]:
    """Dotted paths of the packed leaves of one layer's tree."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _packed_paths(v, f"{prefix}{k}.")
        elif isinstance(v, (TiledCSC, BlockCSR)):
            out.append(f"{prefix}{k}")
    return out


def _at(tree: dict, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _projections(params):
    """Every layer's packed projections by path (``attn.wq``, ``mlp.w_up``,
    an MoE block's ``moe.shared.w_up``), and a packed untied ``head``."""
    layers = params["layers"]
    out = {p: [_at(layer, p) for layer in layers] for p in _packed_paths(layers[0])}
    if isinstance(params.get("head"), (TiledCSC, BlockCSR)):
        out["head"] = [params["head"]]
    return out


def phase_slice(cell: str) -> dict:
    """Prepare the cell's weights once, serve them through ``serve.main``
    with every launch count read around the run, then hold the prefill
    against the same weights densified."""
    argv, sod, kernel, qmode, layers = CELLS[cell]
    args = serve.parse_args(argv)
    cfg = configs.get_config(args.arch).with_(n_layers=layers)
    t0 = time.perf_counter()
    model, params, tokens, *_ = serve.prepare(args, sod, cfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=(model, params, tokens))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = layers * 7 * (1 + 16)
    if launches != expect or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}")
    if not summary["logits_finite"]:
        raise AssertionError(f"{cell}: non-finite logits from the full-width serve")
    wb = summary["weight_bytes"]
    if not wb["compressed"] < wb["dense"]:
        raise AssertionError(f"{cell}: compressed bytes not below dense: {wb}")
    proj = _projections(params)
    packed = [w for ws in proj.values() for w in ws]
    if {w.qmode for w in packed} != {qmode}:
        raise AssertionError(f"{cell}: packed qmodes {({w.qmode for w in packed})}, "
                             f"want {qmode}")
    log({"phase": "slice", "cell": cell, "qmode": qmode, "layers": layers,
         "pack_s": pack_s, "launches": launches,
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "sample": summary["sample"], "weight_bytes": wb})

    row = check_vs_dense(cell, model, params, tokens, kernel, layers)
    decompress_launches = row["decompress_launches"]
    return {"launches": launches[kernel], "decompress_launches": decompress_launches,
            "weight_bytes": wb, "layer_bytes": row["projection_bytes"] / layers,
            "model": model, "params": params, "tokens": tokens}


@contextlib.contextmanager
def _routing(record: list | None = None, replay: list | None = None,
             differ: list | None = None):
    """While open, every MoE block's top-k appends its expert ids to
    ``record``, or (``replay``) takes the next ids recorded instead of
    choosing, with the gate values at them, so a second forward routes
    every token as the first did (in a partitioned step, the rank's rows
    of them); ``differ`` then gets, per block, the number of tokens whose
    own expert set differs and the tokens."""
    from repro_torch.runtime import spmd

    top_k = moe._top_k

    def pinned(probs, k):
        if replay is not None:
            ids = replay.pop(0)
            part, t = spmd.active_partition(), probs.shape[0]
            if part is not None and part.rows and ids.shape[0] != t:
                ids = ids[part.mesh.index(part.rows) * t:][:t]
            if differ is not None:
                own = top_k(probs, k)[1].sort(-1).values
                differ.append((int((own != ids.sort(-1).values).any(-1).sum()),
                               int(ids.shape[0])))
            return torch.gather(probs, -1, ids), ids
        vals, ids = top_k(probs, k)
        record.append(ids)
        return vals, ids
    moe._top_k = pinned
    try:
        yield
    finally:
        moe._top_k = top_k


def check_vs_dense(label: str, model, params, tokens, kernel: str, layers: int,
                   per_layer: int = 7, want_packed: int | None = None,
                   prefill=None) -> dict:
    """The same weights, prefill through the kernel and through the dense
    matmul on the weights densified by ops.decompress: logits within
    LOGIT_TOL of the dense path's largest, and ``decompress`` launched once
    a packed TiledCSC projection (all ``layers`` x ``per_layer`` of them,
    and a packed head, when the ``kernel`` is ``sod_matmul``; a recurrent
    model's ``want_packed``, every packed leaf of its tree).  ``prefill``
    (weights → (last logits, cache)) replaces ``model.prefill``: a
    recurrent model's is the serve path's, the prompt stepped through the
    decode step.  An MoE
    model's dense path routes every token to the experts the kernel path
    chose (:func:`_routing`): a top-k choice is a step function of the
    router's logits, so a rounding apart between the paths can send a token
    to another expert, which the gate would charge to the kernels; the
    dense path routed by its own logits is logged beside (its error, argmax
    agreement, and the share of (token, layer) expert sets that differ).
    Returns the logged row (without the logits, which are under
    ``"logits"``; the seconds of both prefills under ``kernel_prefill_s``
    and ``dense_prefill_s``)."""
    proj = (_recurrent_packed(params) if want_packed is not None
            else _projections(params))
    prefill = prefill or (lambda p: model.prefill(p, tokens))
    packed = [w for ws in proj.values() for w in ws]
    routed = model.cfg.family == "moe"
    kernel_ids, free_ids, free = [], [], {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _routing(record=kernel_ids) if routed else contextlib.nullcontext():
            lk, _ = prefill(params)
        torch.cuda.synchronize()
        kernel_prefill_s = time.perf_counter() - t0
        dk.launches = 0
        dense = _densify(params)
        decompress_launches = dk.launches
        vocab = model.cfg.vocab
        lk = lk[:, :vocab].float()
        if routed:
            with _routing(record=free_ids):
                lf = model.prefill(dense, tokens)[0][:, :vocab].float()
            flips = [(a.sort(-1).values != b.sort(-1).values).any(-1).float().mean().item()
                     for a, b in zip(kernel_ids, free_ids)]
            free = {"own_routing_max_abs_err": (lk - lf).abs().max().item(),
                    "own_routing_argmax_agreement":
                        (lk.argmax(-1) == lf.argmax(-1)).float().mean().item(),
                    "own_routing_expert_sets_that_differ": statistics.mean(flips)}
            del lf
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _routing(replay=list(kernel_ids)) if routed else contextlib.nullcontext():
            ld, _ = prefill(dense)
        torch.cuda.synchronize()
        dense_prefill_s = time.perf_counter() - t0
        del dense
        ld = ld[:, :vocab].float()
        err = (lk - ld).abs().max().item()
        scale = ld.abs().max().item()
        agree = (lk.argmax(-1) == ld.argmax(-1)).float().mean().item()
    want_decompress = sum(isinstance(w, TiledCSC) for w in packed)
    if decompress_launches != want_decompress or (
            kernel == "sod_matmul"
            and want_decompress != (want_packed if want_packed is not None
                                    else layers * per_layer + ("head" in proj))):
        raise AssertionError(f"{label}: densifying launched decompress "
                             f"{decompress_launches} times, want {want_decompress}")
    row = {"phase": "slice_vs_dense", "cell": label, "max_abs_err": err,
           "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
           "argmax_agreement": agree, "decompress_launches": decompress_launches,
           "kernel_prefill_s": kernel_prefill_s, "dense_prefill_s": dense_prefill_s,
           **({"routing": "the kernel path's expert choices", **free} if routed else {}),
           "projection_bytes": sum(sod_mod.weight_bytes(w) for w in packed),
           "projection_bytes_dense": sum(w.nbytes_dense() if hasattr(w, "nbytes_dense")
                                         else sod_mod.weight_bytes(w) for w in packed)}
    if kernel == "sod_matmul":
        row["caps"] = {name: ws[0].cap for name, ws in proj.items()}
    elif kernel == "block_matmul":
        row["bcaps"] = {name: ws[0].bcap for name, ws in proj.items()}
        row["stored_share"] = {
            name: sum(int(w.tile_nnz.sum()) for w in ws)
            / sum(w.tile_nnz.numel() * (w.tile[0] // w.br) for w in ws)
            for name, ws in proj.items()}
        row["projection_bytes_stored_blocks"] = sum(
            int(w.tile_nnz.sum()) * w.br * w.tile[1] * w.block_vals.element_size()
            for w in packed)
    log(row)
    if not (torch.isfinite(lk).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"{label}: kernel-path logits differ from the dense "
                             f"path: {err} > {LOGIT_TOL * scale}")
    return {**row, "logits": lk}


def check_quantized_bytes(cells: dict) -> None:
    """Each quantized cell stores fewer bytes than its format's unquantized
    cell: in all (same depth) and per layer of projections."""
    for cell, (_, _, kernel, qmode, layers) in CELLS.items():
        if qmode == "none":
            continue
        base = cells[UNQUANTIZED[kernel]]
        per_layer = cells[cell]["layer_bytes"] < base["layer_bytes"]
        total = (layers != LAYERS or cells[cell]["weight_bytes"]["compressed"]
                 < base["weight_bytes"]["compressed"])
        if not (per_layer and total):
            raise AssertionError(f"{cell}: quantized bytes not below "
                                 f"{UNQUANTIZED[kernel]}'s")


def phase_profile(cell: str, model, params, tokens) -> None:
    """Device time by kernel over one steady decode step, and the device's
    idle share of an unprofiled step (the profiler slows the host down)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        _, cache, pos = serve.prefill_cache(model, params, tokens, 48)
        tok = torch.zeros((tokens.shape[0], 1), dtype=torch.long, device="cuda")
        model.decode_step(params, cache, tok, pos)
        step_ms = []
        for t in range(1, 8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos + t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos + 8)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict[str, tuple[float, int]] = {}
    for ev in prof.events():      # device events only: operators would count twice
        if ev.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    step = statistics.median(step_ms)
    reduce_calls = sum(n for k, (_, n) in per_kernel.items() if "reduce_splits_kernel" in k)
    log({"phase": "profile", "cell": cell,
         "what": "one decode step, batch 4, full width",
         "step_ms_median_of_7": step, "profiled_wall_ms": wall_ms,
         "device_ms": total_ms if rows else "not measured",
         "device_idle_share": (1 - total_ms / step) if rows else "not measured",
         "reduce_splits_calls": reduce_calls,
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                 for us, k, c in rows[:12]]})
    if reduce_calls:
        raise AssertionError(f"{cell}: {reduce_calls} reduce_splits_kernel calls in a "
                             "decode step; the matmul kernels reduce their splits in "
                             "their launch")


def phase_head(params, batch: int) -> None:
    """The tied LM head's GEMM at decode: f32 output (what project_logits
    runs) against bf16 output widened after (what it ran before)."""
    flush = timing.flush_buffer()
    embed = params["embed"]
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    x = torch.randn(batch, embed.shape[1], generator=g, device="cuda").to(embed.dtype)
    f32_out = _time_ms(lambda: torch.mm(x, embed.T, out_dtype=torch.float32), flush)
    bf16_out = _time_ms(lambda: torch.mm(x, embed.T).float(), flush)
    log({"phase": "head", "M": batch, "K": embed.shape[1], "N": embed.shape[0],
         "f32_out_ms": f32_out, "bf16_out_then_widen_ms": bf16_out,
         "bound_ms": _bound(_nbytes(embed), 2 * batch * embed.numel(),
                            embed.dtype)[0]})


ENGINE_ARGV = ["--arch", "llama3.2-1b", "--engine", "--requests", "8",
               "--arrival-rate", "0.5", "--prompt-len", "64", "--gen", "16",
               "--max-slots", "4", "--page-size", "16", "--seed", "0",
               "--device", "cuda"]
# run -> (phase-4 cell whose packed weights it serves, prefill chunk)
ENGINE_RUNS = {"tiled_csc": ("tiled_csc", None),
               "tiled_csc_chunk16": ("tiled_csc", 16),
               "block_csr": ("block_csr", None)}


def _prefill_splits(kernel: str, params, ms) -> dict:
    """The K splits of the kernel's launch plan at each projection shape of
    a layer and each row count in ``ms``."""
    out = {}
    for g in ("attn", "mlp"):
        for name, w in params["layers"][0][g].items():
            x = torch.empty((1, w.shape[0]), dtype=torch.bfloat16, device="cuda")
            out[f"{g}.{name}"] = {
                m: PLANS[kernel](x.expand(m, -1), w).splits for m in ms}
    return out


def phase_engine(run: str, cells: dict) -> dict:
    """One engine run through ``serve.main --engine`` on a phase-4 cell's
    packed weights, held against ``static_generate`` request by request."""
    cell, chunk = ENGINE_RUNS[run]
    kernel = CELLS[cell][2]
    argv = ENGINE_ARGV + (["--prefill-chunk", str(chunk)] if chunk else [])
    sl = cells[cell]
    reset_counts()
    summary = serve.main(argv, prepared=(sl["model"], sl["params"], sl["tokens"]))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    trace, tokens = summary["trace"], summary["tokens"]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    if not (launches[kernel] > 0 and launches[other] == 0
            and launches["decompress"] == 0
            and summary["kernel_launches"] == {kernel: launches[kernel], other: 0}):
        raise AssertionError(f"engine {run}: launches {launches} (summary "
                             f"{summary['kernel_launches']})")
    if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {summary['completed']} of "
                             f"{len(trace)} requests completed")
    if not summary["logits_finite"]:
        raise AssertionError(f"engine {run}: non-finite logits")
    t0 = time.perf_counter()
    with torch.inference_mode():
        for req in trace:
            want = static_generate(sl["model"], sl["params"], req)
            if tokens[req.rid] != want:
                first = next(i for i, (a, b) in enumerate(zip(tokens[req.rid], want))
                             if a != b)
                raise AssertionError(
                    f"engine {run}: request {req.rid} (prompt {len(req.tokens)}) "
                    f"differs from static_generate at token {first}: "
                    f"{tokens[req.rid]} vs {want}")
    static_s = time.perf_counter() - t0
    buckets = sorted({bucket_len(len(r.tokens), 16) for r in trace})
    ms = sorted({1, 4, *([chunk] if chunk else buckets)})
    row = {"phase": "engine", "run": run, "cell": cell, "prefill_chunk": chunk,
           "launches": launches[kernel],
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           "prompt_lens": [len(r.tokens) for r in trace],
           "splits": _prefill_splits(kernel, sl["params"], ms),
           **{k: summary[k] for k in (
               "completed", "steps", "generated_tokens", "prefill_chunks",
               "warmup_s", "steady_s", "steady_tok_per_s", "p50_latency_s",
               "p99_latency_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
               "tpot_p99_s", "step_ms_p50", "step_ms_p99", "logits_finite")}}
    log(row)
    return row


def phase_engine_profile(cells: dict) -> None:
    """Device time and idle share of one steady engine step (tiled_csc,
    fused prefill): the trace runs until every slot decodes, then one step
    is profiled and the next eight are timed unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sl = cells["tiled_csc"]
    args = serve.parse_args(ENGINE_ARGV)
    max_len = bucket_len(args.prompt_len, args.page_size,
                         sl["model"].cfg.attn_chunk) + args.gen
    eng = Engine(sl["model"], sl["params"], max_slots=4, page_size=16,
                 max_len=max_len)
    for r in poisson_trace(8, 0.5, max_prompt=64, max_new=16,
                           vocab=sl["model"].cfg.vocab, seed=0):
        # all admissible at once: 4 slots decode
        eng.submit(dataclasses.replace(r, arrival=0))
    with torch.inference_mode():
        eng.warmup()
        eng.step()                   # admits 4, each with its fused prefill
        eng.step()
        step_ms = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
    dev_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    step = statistics.median(step_ms)
    log({"phase": "engine_profile", "cell": "tiled_csc",
         "what": "one engine step, 4 slots decoding, full width",
         "step_ms_median_of_8": step,
         "device_ms": dev_us / 1e3 if dev_us else "not measured",
         "device_idle_share": (1 - dev_us / 1e3 / step) if dev_us else "not measured"})


# run -> (phase-4 cell whose packed weights are the target, the engine's
# features, its pool's pages (None: room for every slot))
FEATURE_RUNS = {
    "tiled_csc_stress": ("tiled_csc", dict(prefill_chunk=16, preemption=True,
                                           prefix_sharing=True), 8),
    "tiled_csc_spec2": ("tiled_csc", dict(spec_k=2), None),
    "block_csr_stress_spec": ("block_csr", dict(prefill_chunk=16, preemption=True,
                                                prefix_sharing=True, spec_k=2), 11),
    "tiled_csc_cache": ("tiled_csc", dict(prefill_chunk=16, prefix_sharing=True),
                        None),
}
DRAFT_SPARSITY = 0.88         # the draft tier keeps 0.12 of the raw weights
SPEC_ARGV = ENGINE_ARGV + ["--spec-decode", "2", "--draft-sparsity", str(DRAFT_SPARSITY)]
CACHE_BUDGET_PAGES = 3
STEP_BUILDERS = ("make_paged_decode_step", "make_prefill_full",
                 "make_chunked_prefill_step", "make_verify_step")


def _matmul_launches() -> int:
    return sm.launches + bmm.launches


@contextlib.contextmanager
def _engine_probe(target_params):
    """While open, every engine built counts the matmul launches of its steps
    by tier (the target's weights or any other: the draft's) and its step
    calls (each a forward over every layer), and the engines ``serve.main``
    builds are kept."""
    seen = {"target": 0, "draft": 0, "engines": [], "calls": 0}
    builders = {name: getattr(steps_mod, name) for name in STEP_BUILDERS}
    serve_engine = serve.Engine

    def counted(build):
        def make(model, mesh=None, plan=None):
            step = build(model, mesh=mesh, plan=plan)

            def run(params, *a, **kw):
                n0 = _matmul_launches()
                out = step(params, *a, **kw)
                tier = "target" if params is target_params else "draft"
                seen[tier] += _matmul_launches() - n0
                seen["calls"] += 1
                return out
            return run
        return make

    def keep(*a, **kw):
        eng = serve_engine(*a, **kw)
        seen["engines"].append(eng)
        return eng

    for name, build in builders.items():
        setattr(steps_mod, name, counted(build))
    serve.Engine = keep
    try:
        yield seen
    finally:
        for name, build in builders.items():
            setattr(steps_mod, name, build)
        serve.Engine = serve_engine


def _youngest_first(eng, log: list) -> None:
    """Record, at each preemption, whether the victim is the youngest
    decoding sequence (the scheduler's rule)."""
    preempt = eng._preempt

    def check(seq):
        decoding = [s for s in eng.sched.active.values() if not s.is_prefilling]
        log.append(seq is max(decoding, key=lambda s: s.req.priority))
        preempt(seq)
    eng._preempt = check


def _page_bytes(model) -> int:
    """KV bytes of one page across every layer (the prefix cache's unit)."""
    k = model.init_paged_pool(1, 16, "cuda")["k"]
    return 2 * k.numel() * k.element_size()


def _check_tokens(run: str, model, params, trace, tokens, plan=None) -> float:
    t0 = time.perf_counter()
    with torch.inference_mode():
        for req in trace:
            want = static_generate(model, params, req, plan=plan)
            if tokens[req.rid] != want:
                first = next(i for i, (a, b) in enumerate(zip(tokens[req.rid], want))
                             if a != b)
                raise AssertionError(
                    f"engine {run}: request {req.rid} (prompt {len(req.tokens)}) "
                    f"differs from static_generate at token {first}: "
                    f"{tokens[req.rid]} vs {want}")
    return time.perf_counter() - t0


def feature_run(run: str, cells: dict, drafts: dict) -> dict:
    """One run of FEATURE_RUNS on a phase-4 cell's packed weights (the
    draft tiers in ``drafts`` by cell): the engine, its trace, tokens and
    stats, the kernels' launches by tier, and what the run's gates read."""
    cell, features, n_pages = FEATURE_RUNS[run]
    sl = cells[cell]
    model, params = sl["model"], sl["params"]
    vocab = model.cfg.vocab
    victims: list[bool] = []
    extra = {}
    reset_counts()
    with _engine_probe(params) as seen, torch.inference_mode():
        if run == "tiled_csc_spec2":
            summary = serve.main(SPEC_ARGV, prepared=(model, params, sl["tokens"]))
            (eng,) = seen["engines"]
            trace, tokens, stats = summary["trace"], summary["tokens"], dict(eng.stats)
            extra = {k: summary[k] for k in ("draft_density", "draft_bytes")}
        elif run == "tiled_csc_cache":
            cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
            eng = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         prefix_cache_budget=CACHE_BUDGET_PAGES * _page_bytes(model),
                         prefix_cache_dir=cache_dir, **features)
            epochs = [repeated_prompt_trace(4, prefix_len=32, suffix_len=16, max_new=8,
                                            vocab=vocab, page_size=16, rid_base=base)
                      for base in (0, 4)]
            fresh1 = eng.run(epochs[0])["stats"]["prompt_pages_fresh"]
            res = eng.run(epochs[1])
            trace, tokens, stats = epochs[0] + epochs[1], res["tokens"], res["stats"]
            eng.flush_prefix_cache()
            shutil.rmtree(cache_dir)
            extra = {"epoch1_fresh_pages": fresh1,
                     "epoch2_fresh_pages": stats["prompt_pages_fresh"] - fresh1}
        else:
            draft = drafts[cell] if features.get("spec_k") else None
            eng = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         n_pages=n_pages, draft_params=draft, **features)
            _youngest_first(eng, victims)
            trace = (shared_prefix_trace(8, prefix_len=32, max_prompt=64, max_new=16,
                                         vocab=vocab, seed=0, arrival_gap=2)
                     if run == "tiled_csc_stress" else
                     stress_spec_trace(8, prefix_len=32, max_prompt=64, max_new=16,
                                       vocab=vocab, seed=0, burst=2, rate=0.3))
            res = eng.run(trace)
            tokens, stats = res["tokens"], res["stats"]
    return {"eng": eng, "trace": trace, "tokens": tokens, "stats": stats,
            "seen": seen, "victims": victims, "extra": extra,
            "launches": {name: mod.launches for name, mod in COUNTERS.items()}}


def phase_feature(run: str, cells: dict, drafts: dict) -> dict:
    """One run of the engine's other stages (:func:`feature_run`), held
    against ``static_generate`` request by request, with its features'
    gates."""
    cell, features, _ = FEATURE_RUNS[run]
    kernel = CELLS[cell][2]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    model, params = cells[cell]["model"], cells[cell]["params"]
    out = feature_run(run, cells, drafts)
    eng, trace, tokens, stats = out["eng"], out["trace"], out["tokens"], out["stats"]
    seen, victims, extra, launches = (out["seen"], out["victims"], out["extra"],
                                      out["launches"])
    if not (launches[kernel] > 0 and launches[other] == 0
            and launches["decompress"] == 0
            and seen["target"] + seen["draft"] == launches[kernel]):
        raise AssertionError(f"engine {run}: launches {launches}, by tier {seen}")
    if stats["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {stats['completed']} of {len(trace)} "
                             "requests completed")
    if not stats["logits_finite"]:
        raise AssertionError(f"engine {run}: non-finite logits")
    pool = eng.page_pool
    if (pool.free_count != pool.n_pages - 1 or pool.allocated
            or (eng.trie is not None and len(eng.trie))):
        raise AssertionError(f"engine {run}: pool not clean: {pool.free_count} of "
                             f"{pool.n_pages - 1} free")
    if run == "tiled_csc_cache":      # the same two epochs with the cache off
        with torch.inference_mode():
            off = Engine(model, params, max_slots=4, page_size=16, max_len=80,
                         **features).run(trace)["tokens"]
        extra["equals_cache_off"] = tokens == off
    gates = {
        "tiled_csc_stress": (stats["preemptions"] >= 1 and stats["swapped_in_pages"] >= 1
                             and stats["shared_prompt_pages"] >= 1 and all(victims)),
        "tiled_csc_spec2": stats["spec_windows"] >= 1 and seen["draft"] > 0,
        "block_csr_stress_spec": (stats["preemptions"] >= 1 and stats["spec_rollbacks"] >= 1
                                  and all(victims) and seen["draft"] > 0),
        "tiled_csc_cache": (extra.get("epoch2_fresh_pages") == 0
                            and stats["prefix_demotions_disk"] >= 1
                            and extra.get("equals_cache_off")),
    }
    static_s = _check_tokens(run, model, params, trace, tokens)
    row = {"phase": "engine", "run": run, "cell": cell, "n_pages": pool.n_pages,
           "features": features, "launches": launches[kernel],
           "launches_by_tier": {"target": seen["target"], "draft": seen["draft"]},
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           "youngest_decoding_evicted_first": victims, **extra,
           **{k: stats[k] for k in (
               "completed", "steps", "generated_tokens", "tokens_per_step",
               "acceptance_rate", "warmup_s", "steady_s", "steady_tok_per_s",
               "p50_latency_s", "p99_latency_s", "step_ms_p50", "step_ms_p99",
               "logits_finite")},
           "counters": {k: v for k, v in stats.items() if isinstance(v, int)
                        and not isinstance(v, bool) and k not in ("steps", "completed",
                                                                  "generated_tokens")}}
    if run in ("tiled_csc_stress", "block_csr_stress_spec"):
        row["preempt_log"] = eng.preempt_log
    log(row)
    if not gates[run]:
        raise AssertionError(f"engine {run}: a feature gate failed: {row}")
    return row


def _device_ms(fn) -> float:
    """Device ms of one call of ``fn`` under ``torch.profiler`` (after one
    call unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3


def _wall_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn`` with the card synchronized around each call
    (host enqueue and device time together)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_spec_profile(cells: dict, draft) -> None:
    """Device time of one spec window (k = 2: the k + 1 draft decode steps
    the engine runs, then the verify pass) beside k + 1 plain decode steps,
    tiled_csc, 4 slots decoding at the same positions; and one whole engine
    step that runs a window: its device time against the unprofiled wall
    time of the step before it (the idle share)."""
    sl = cells["tiled_csc"]
    model, params = sl["model"], sl["params"]
    k = 2
    eng = Engine(model, params, max_slots=4, page_size=16, max_len=80, spec_k=k,
                 draft_params=draft)
    for r in poisson_trace(4, 0.5, max_prompt=64, max_new=16,
                           vocab=model.cfg.vocab, seed=0):
        eng.submit(dataclasses.replace(r, arrival=0, max_new=16))
    with torch.inference_mode():
        eng.warmup()
        eng.step()                   # admits 4 (fused prefills) and a window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3
        step_dev = _device_ms(eng.step)
        if len(eng.sched.active) != 4:
            raise AssertionError("spec profile: not every slot is still decoding")
        bt, tok, pos, valid = eng._decode_inputs(eng._valid_lens())

        def draft_steps():
            d = tok
            for j in range(k + 1):
                d = eng._draft_decode(eng.draft_params, eng.draft_pool, bt, d,
                                      pos + j, valid)[0].reshape(4, 1)

        window = torch.cat([tok, tok.expand(4, k)], 1)

        def verify():
            eng._verify(params, eng.pool, bt, window, pos, valid)

        def plain_steps():
            for j in range(k + 1):
                eng._decode(params, eng.pool, bt, tok, pos + j, valid)

        draft_ms, verify_ms, plain_ms = map(_device_ms, (draft_steps, verify, plain_steps))
        wall = {name: _wall_ms(fn) for name, fn in (
            ("draft_steps", draft_steps), ("verify", verify), ("plain_decode_steps",
                                                                plain_steps))}
    log({"phase": "spec_profile", "cell": "tiled_csc", "k": k,
         "what": "4 slots decoding, full width; device ms from torch.profiler, "
                 "wall ms synchronized (median of 5)",
         "draft_steps_ms": draft_ms, "verify_ms": verify_ms,
         "window_ms": draft_ms + verify_ms, "plain_decode_steps_ms": plain_ms,
         "wall_ms": wall,
         "engine_step_device_ms": step_dev, "engine_step_wall_ms": step_wall,
         "engine_step_idle_share": (1 - step_dev / step_wall) if step_dev else
         "not measured"})


# ---------------------------------------------------------------------------
# phase 7: the planner and the tuned dispatch
# ---------------------------------------------------------------------------
PLAN_RUNS = ("plan_tiled_csc", "plan_replay", "plan_block_csr", "plan_quantize_auto",
             "plan_engine", "plan_spec")
TILED_ENGINE_ARGV = ENGINE_ARGV + ["--sod", "tiled_csc", "--density", str(DENSITY)]
IMPL_KERNEL = {"cuda_fused": "sod_matmul", "cuda_block": "block_matmul"}


def _same_packs(a: dict, b: dict) -> bool:
    """Every projection of every layer of two packed trees: the same format
    and layout, and every buffer bit-equal."""
    for la, lb in zip(a["layers"], b["layers"], strict=True):
        for g in ("attn", "mlp"):
            for n, wa in la[g].items():
                wb = lb[g][n]
                if type(wa) is not type(wb):
                    return False
                if isinstance(wa, torch.Tensor):    # a plan's dense entry
                    if not (wa.dtype == wb.dtype and torch.equal(wa, wb)):
                        return False
                    continue
                for f in dataclasses.fields(wa):
                    va, vb = getattr(wa, f.name), getattr(wb, f.name)
                    if isinstance(va, torch.Tensor):
                        if not (isinstance(vb, torch.Tensor) and va.dtype == vb.dtype
                                and torch.equal(va, vb)):
                            return False
                    elif va != vb:
                        return False
    return True


def _dispatch_gate(run: str, summary: dict, impl: str) -> dict:
    """The run's dispatches by ``impl[source]``: fails if the plain version
    ran on the card or another impl than ``impl`` was chosen."""
    counts = summary["kernel_dispatch"]
    if not counts or any(not k.startswith(f"{impl}[") for k in counts):
        raise AssertionError(f"{run}: dispatches {counts}, want only {impl}")
    return counts


def _winners(cache_path: str) -> list[dict]:
    """Each tuned (layout, M bucket): the winner's launch and time beside the
    untuned launch's, from the tuning cache file."""
    raw = json.loads(pathlib.Path(cache_path).read_text())
    return [{"key": k, "impl": e["impl"], "params": e["params"], "us": e["us"],
             "default_us": e.get("default_us")}
            for k, e in sorted(raw["entries"].items())]


def _plan_run(run: str, argv: list[str], impl: str, sod: SoDConfig | None = None,
              prepared=None) -> tuple[dict, object, float]:
    """One ``serve`` run of phase 7: its weights prepared (and planned,
    tuned) from the flags unless ``prepared`` is given, then served with
    every launch count read around the serve.  Returns (summary, prepared,
    prepare seconds)."""
    t0 = time.perf_counter()
    args = serve.parse_args(argv)
    prep = prepared or serve.prepare(args, sod, configs.get_config(args.arch).with_(
        n_layers=LAYERS))
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=prep)
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    kernel = IMPL_KERNEL[impl]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    if not (launches[kernel] > 0 and launches[other] == 0 and launches["decompress"] == 0):
        raise AssertionError(f"{run}: launches {launches}")
    _dispatch_gate(run, summary, impl)
    if not summary["logits_finite"]:
        raise AssertionError(f"{run}: non-finite logits")
    summary["launches"] = launches[kernel]
    return summary, prep, prepare_s


def _plan_row(run: str, summary: dict, prepare_s: float, **extra) -> dict:
    row = {"phase": "plan", "run": run, "prepare_s": prepare_s,
           "launches": summary["launches"], "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("plan_s", "autotune", "autotune_s", "plan_layers",
                                      "plan_bytes") if k in summary}, **extra}
    log(row)
    return row


def _engine_gate(run: str, summary: dict, model, params, plan) -> float:
    trace, tokens = summary["trace"], summary["tokens"]
    if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"{run}: {summary['completed']} of {len(trace)} "
                             "requests completed")
    return _check_tokens(run, model, params, trace, tokens, plan)


def phase_plan(cells: dict) -> dict:
    """Phase 7's six runs (PLAN_RUNS) on one tuning cache in a temporary
    directory; returns each run's row."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    tc, pj = f"{tmp}/tuning_cache.json", f"{tmp}/plan.json"
    rows = {}
    try:
        # plan_tiled_csc: plan from the weights, tuned, saved
        run = "plan_tiled_csc"
        argv = TILED_ARGV + ["--plan", "auto", "--autotune", "--tuning-cache", tc,
                             "--plan-json", pj]
        summary, prep, prepare_s = _plan_run(run, argv, "cuda_fused")
        if not _same_packs(prep.params, cells["tiled_csc"]["params"]):
            raise AssertionError(f"{run}: packs differ from phase 4's tiled_csc")
        if not summary["autotune"]["tuned"] > 0:
            raise AssertionError(f"{run}: nothing tuned: {summary['autotune']}")
        check_vs_dense(run, prep.model, prep.params, prep.tokens, "sod_matmul", LAYERS)
        rows[run] = _plan_row(run, summary, prepare_s, packs_equal_phase4=True,
                              winners=_winners(tc),
                              plan={p: e.describe() for p, e in prep.plan.entries.items()})
        first = summary

        # plan_replay: the saved plan on the warm cache
        run = "plan_replay"
        argv = TILED_ARGV + ["--plan", pj, "--autotune", "--tuning-cache", tc]
        summary, replay, prepare_s = _plan_run(run, argv, "cuda_fused")
        if summary["autotune"]["tuned"] != 0:
            raise AssertionError(f"{run}: measured again: {summary['autotune']}")
        if not _same_packs(replay.params, prep.params):
            raise AssertionError(f"{run}: packs differ from plan_tiled_csc's")
        if summary["generated_ids"] != first["generated_ids"]:
            raise AssertionError(f"{run}: tokens differ from plan_tiled_csc's")
        rows[run] = _plan_row(run, summary, prepare_s, packs_equal=True,
                              tokens_equal=True)
        del prep

        # plan_block_csr: the block kernel only
        run = "plan_block_csr"
        argv = BASE_ARGV + ["--sod", "block_csr", "--density", str(DENSITY),
                            "--plan", "auto", "--autotune", "--tuning-cache", tc]
        summary, prep, prepare_s = _plan_run(run, argv, "cuda_block", sod=_block_sod())
        rows[run] = _plan_row(run, summary, prepare_s)
        del prep

        # plan_quantize_auto: the planner's qmodes
        run = "plan_quantize_auto"
        argv = TILED_ARGV + ["--plan", "auto", "--quantize", "auto",
                             "--tuning-cache", tc]
        summary, prep, prepare_s = _plan_run(run, argv, "cuda_fused")
        qmodes = {p: e.qmode for p, e in prep.plan.entries.items()}
        packed = {w.qmode for ws in _projections(prep.params).values() for w in ws}
        if packed != set(qmodes.values()):
            raise AssertionError(f"{run}: packed qmodes {packed}, plan {qmodes}")
        check_vs_dense(run, prep.model, prep.params, prep.tokens, "sod_matmul", LAYERS)
        rows[run] = _plan_row(run, summary, prepare_s, qmodes=qmodes,
                              notes={p: e.note for p, e in prep.plan.entries.items()},
                              packed_qmodes=sorted(packed))
        del prep

        # plan_engine: the saved plan and warm cache under the engine
        run = "plan_engine"
        argv = TILED_ENGINE_ARGV + ["--plan", pj, "--tuning-cache", tc]
        summary, _, _ = _plan_run(run, argv, "cuda_fused", prepared=replay)
        static_s = _engine_gate(run, summary, replay.model, replay.params, replay.plan)
        rows[run] = _plan_row(run, summary, 0.0, bit_equal_to_static_generate=True,
                              static_generate_s=static_s,
                              **{k: summary[k] for k in ("completed", "steady_tok_per_s",
                                                         "step_ms_p50", "warmup_s")})
        del replay

        # plan_spec: the planner picks the draft density
        run = "plan_spec"
        argv = TILED_ENGINE_ARGV + ["--plan", "auto", "--tuning-cache", tc,
                                    "--spec-decode", "2"]
        summary, prep, prepare_s = _plan_run(run, argv, "cuda_fused")
        static_s = _engine_gate(run, summary, prep.model, prep.params, prep.plan)
        rows[run] = _plan_row(run, summary, prepare_s, bit_equal_to_static_generate=True,
                              static_generate_s=static_s,
                              **{k: summary[k] for k in (
                                  "draft_density", "draft_density_choice", "draft_bytes",
                                  "spec_windows", "acceptance_rate", "completed",
                                  "steady_tok_per_s")})
        del prep
    finally:
        autotune.set_cache(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ      # the rows of every training matmul
# phase 8's runs at 4 of llama's 16 layers, for the script's time: each run
# writes two checkpoints of the whole state (11.5 GB at 16 layers) and the
# three took 80 s of a 948 s run on an H100
TRAIN_LAYERS = 4
# the learning rate of the reference's own training tests (tests/test_system.py)
TRAIN_ARGV = ["--arch", "llama3.2-1b", "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--warmup", "2", "--lr", "3e-3", "--seed", "0",
              "--device", "cuda",
              "--ckpt-every", "1000", "--log-every", "1000"]
# run -> (flags, kernel, its registry impl, steps)
TRAIN_RUNS = {
    "train_tiled_csc": (["--sod", "tiled_csc", "--density", str(DENSITY)], "sod_matmul",
                        "cuda_fused", 12),
    "train_block_csr": (["--sod", "block_csr", "--density", str(DENSITY)], "block_matmul",
                        "cuda_block", 6),
    "train_tiled_csc_int8": (["--sod", "tiled_csc", "--quantize", "int8"], "sod_matmul",
                             "cuda_fused", 4),
}
RESUME_ARGV = ["--arch", "llama3.2-1b", "--reduced", "--sod", "tiled_csc", "--density",
               str(DENSITY), "--batch", "2", "--seq", "32", "--ckpt-every", "5",
               "--seed", "0", "--device", "cuda", "--log-every", "1000"]
GRAD_TOL = {torch.bfloat16: KERNEL_TOL[torch.bfloat16],
            torch.float32: KERNEL_TOL[torch.float32],
            torch.float8_e4m3fn: 2**-3}     # fp8 codes: one e4m3 rounding apart


def _train_qmode(run: str) -> str:
    flags = TRAIN_RUNS[run][0]
    return flags[flags.index("--quantize") + 1] if "--quantize" in flags else "none"


def _float_leaves(p) -> list[str]:
    return [f for f in ("vals", "block_vals", "scale", "codebook")
            if getattr(p, f, None) is not None and getattr(p, f).is_floating_point()]


def _backward(x, p, g, kernel: bool, out_dtype=None) -> dict:
    """(y, dx, d of the operand's float buffers) for the cotangent ``g``:
    through the kernel's autograd.Function, or autograd over the plain
    version, the output in ``out_dtype`` (x's dtype when None)."""
    xx = x.detach().clone().requires_grad_(True)
    leaves = {f: getattr(p, f).detach().clone().requires_grad_(True)
              for f in _float_leaves(p)}
    w = dataclasses.replace(p, **leaves)
    if not kernel:
        y = ref.sod_matmul_ref(xx, w, out_dtype)
    elif isinstance(p, TiledCSC):
        y = vjp.fused_matmul(xx, w, out_dtype, {})
    else:
        y = vjp.block_matmul(xx, w, out_dtype, {})
    y.backward(g)
    return {"y": y.detach(), "x": xx.grad, **{f: t.grad for f, t in leaves.items()}}


def phase_train_grads(qpacks: dict) -> dict:
    """Each differentiable kernel in each qmode at every K×N of the model
    and M = TRAIN_M, bf16 activations: the output, dx and the gradients of
    the packed float buffers from the Function (kernel forward, analytical
    backward re-densifying through ``decompress``) against autograd over
    ``kernels/ref.py`` on the card, under one seeded cotangent; within
    GRAD_TOL of the plain gradient's largest magnitude, exact 0 at padding.
    In qmode none the kernel's forward is also timed at M = TRAIN_M beside
    its plain version, ``torch.matmul`` on the dense weight and its bound,
    as phase 3 times the serving shapes.  Returns (the largest error per
    (kernel, qmode), one layer's 7 projections' times per kernel)."""
    max_err: dict[tuple, float] = {}
    flush = timing.flush_buffer()
    layer_ms: dict[str, dict] = {}
    for name, fmt in (("sod_matmul", "tiled"), ("block_matmul", "block")):
        for qmode in ("none", *QMODES):
            for i, (k, n) in enumerate(PATH_SHAPES):
                g = torch.Generator(device="cuda")
                g.manual_seed(3000 + i)
                if qmode == "none":
                    x, w = _weights(k, n, TRAIN_M, torch.bfloat16, 2000 + i,
                                    block=fmt == "block")
                    p = pack_block_csr(w) if fmt == "block" else pack_tiled_csc(w)
                else:
                    p = qpacks[(fmt, k, n, qmode)]
                    x = torch.randn(TRAIN_M, k, generator=g, device="cuda").to(torch.bfloat16)
                cot = torch.randn(TRAIN_M, n, generator=g, device="cuda").to(torch.bfloat16)
                got, want = _backward(x, p, cot, True), _backward(x, p, cot, False)
                torch.cuda.synchronize()
                errs = {}
                for leaf, ref_grad in want.items():
                    a, b = got[leaf], ref_grad
                    if a.dtype != b.dtype:
                        raise AssertionError(f"{name}[{qmode}] {k}x{n}: d{leaf} dtype "
                                             f"{a.dtype} != {b.dtype}")
                    err = (a.float() - b.float()).abs().max().item()
                    errs[leaf] = err
                    if err > GRAD_TOL[b.dtype] * b.float().abs().max().item():
                        raise AssertionError(f"{name}[{qmode}] {k}x{n}: d{leaf} off by "
                                             f"{err}")
                field = "vals" if fmt == "tiled" else "block_vals"
                pad = (p.rows < 0) if fmt == "tiled" else \
                    (p.block_ids < 0)[..., None, None].expand(p.block_vals.shape)
                pad_zero = field not in got or bool((got[field][pad] == 0).all())
                if not pad_zero:
                    raise AssertionError(f"{name}[{qmode}] {k}x{n}: padding got a gradient")
                key = (name, qmode)
                max_err[key] = max(max_err.get(key, 0.0), *errs.values())
                row = {"phase": "train_grads", "kernel": name, "qmode": qmode, "K": k,
                       "N": n, "M": TRAIN_M, "max_abs_err": errs,
                       "padding_exact_zero": True}
                if qmode == "none":
                    fn = sm.sod_matmul if fmt == "tiled" else bmm.block_matmul
                    dense = p.to_dense().to(x.dtype)
                    times = {"kernel_ms": _time_ms(lambda: fn(x, p), flush),
                             "plain_ms": _time_ms(lambda: ref.sod_matmul_ref(x, p), flush),
                             "library_ms": _time_ms(lambda: torch.matmul(x, dense), flush)}
                    times["bound_ms"] = _bound(*_work(name, x, p, got["y"]),
                                               torch.bfloat16)[0]
                    row.update(times)
                    count = PATH_SHAPES[(k, n)][1]
                    total = layer_ms.setdefault(name, dict.fromkeys(times, 0.0))
                    for t, v in times.items():
                        total[t] += v * count
                log(row)
    return max_err, layer_ms


def _packed(params) -> list:
    """Every layer's packed projections (an untied head apart)."""
    return [_at(layer, p) for layer in params["layers"]
            for p in _packed_paths(layer)]


def train_run(run: str) -> dict:
    """One full-width ``train.main`` run of TRAIN_RUNS at TRAIN_LAYERS with its checkpoints
    in a temporary directory, gated: finite loss and gradient norm at every
    step, the mean of the last 5 losses below the first (runs of 6 steps
    or more), integer leaves
    bit-equal to the initial pack, padding exactly 0, only the format's
    CUDA impl dispatched, its kernel launched 2 × 28 times a step (under
    ``cfg.remat`` the forward runs each block twice), the other not, ``decompress``
    28 times a step for a TiledCSC (the backward's re-densify) and never
    for a BlockCSR; int8: the scales moved.  Returns the summary with the
    run's launches and its seconds."""
    flags, kernel, impl, n_steps = TRAIN_RUNS[run]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
    argv = TRAIN_ARGV + flags + ["--steps", str(n_steps), "--ckpt-dir", tmp]
    try:
        t0 = time.perf_counter()
        args = train.parse_args(argv)
        prep = train.prepare(args, configs.get_config(args.arch).with_(
            n_layers=TRAIN_LAYERS))
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        ints = {k: v.clone() for k, v in leaves_with_path(prep[1])
                if not v.is_floating_point()}
        scales = {k: v.clone() for k, v in leaves_with_path(prep[1]) if k.endswith(".scale")}
        packed, train_cfg = len(_packed(prep[1])), prep[0].cfg
        reset_counts()
        summary = train.main(argv, prepared=prep)
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        del prep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    params = summary["state"]["params"]
    losses, gnorms = summary["losses"], summary["grad_norms"]
    tiled = kernel == "sod_matmul"
    want = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    remat = 2 if train_cfg.remat else 1
    want[kernel] = remat * packed * n_steps
    want["decompress"] = packed * n_steps if tiled else 0
    final_ints = {k: v for k, v in leaves_with_path(params) if not v.is_floating_point()}
    gates = {
        "finite": all(map(math.isfinite, losses + gnorms)),
        "loss_fell": n_steps < 6 or statistics.mean(losses[-5:]) < losses[0],
        "integer_leaves_bit_equal": final_ints.keys() == ints.keys() and all(
            torch.equal(v, ints[k]) for k, v in final_ints.items()),
        "padding_exact_zero": all(
            bool((w.vals[w.rows < 0] == 0).all()) if isinstance(w, TiledCSC)
            else bool((w.block_vals[w.block_ids < 0] == 0).all())
            for w in _packed(params)),
        "dispatch_only_" + impl: bool(summary["kernel_dispatch"]) and all(
            k.startswith(f"{impl}[") for k in summary["kernel_dispatch"]),
        "launches": launches == want and summary["kernel_launches"] == want,
        "checkpoints": [summary["checkpoints"][i]["step"] for i in (0, -1)]
        == [0, n_steps - 1],
    }
    if scales:
        gates["scales_moved"] = any(not torch.equal(v, scales[k])
                                    for k, v in leaves_with_path(params)
                                    if k.endswith(".scale"))
    row = {"phase": "train", "run": run, "layers": train_cfg.n_layers, "steps": n_steps,
           "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "prepare_s": prepare_s, "packed_weights": packed,
           "losses": losses, "grad_norms": gnorms, "launches": launches,
           "launches_want": want, "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
           "checkpoints": summary["checkpoints"], "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"{run}: a gate failed: {gates}")
    return summary


def phase_train_profile(summary: dict, run: str = "train_tiled_csc",
                        argv: list[str] | None = None,
                        layers: int | None = TRAIN_LAYERS) -> None:
    """One steady step of ``run`` (trained from ``argv`` at ``layers``, by
    default ``train_tiled_csc``'s) under ``torch.profiler``, on its final state:
    device time by kernel and by operator class (the matmul kernel's
    forward and remat launches, ``decompress``, the LM head's GEMMs — the
    tied head's, or an untied packed head's backward on its densified
    weight —, the other GEMMs — the projections' backward, the attention's
    einsums, an MoE model's routed experts' products apart — and AdamW's
    foreach kernels), the device's idle share against
    the median wall of 3 unprofiled steps, tok/s and the peak memory of
    those steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = train.parse_args(argv or TRAIN_ARGV + TRAIN_RUNS["train_tiled_csc"][0])
    cfg = configs.get_config(args.arch).with_(sod=SoDConfig(mode="tiled_csc",
                                                           density=DENSITY, min_dim=64))
    if layers:
        cfg = cfg.with_(n_layers=layers)
    model = LM(cfg)
    step = steps_mod.make_train_step(model, AdamW(AdamWConfig(lr=args.lr)))
    state = summary["state"]
    data = SyntheticLMData(cfg, args.batch, args.seq, seed=args.seed)
    batch = to_device(data.batch(12), "cuda")

    def one():
        state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)
        torch.cuda.synchronize()

    one()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        one()
    per_kernel: dict[str, list] = {}
    classes = {"lm_head_gemm": 0.0, "other_gemm": 0.0, "attention_bmm": 0.0,
               "adamw_foreach": 0.0}
    if cfg.family == "moe":      # the routed experts' batched products
        classes["routed_expert_bmm"] = 0.0
        n_experts = transformer.moe_spec(cfg).n_experts_padded
    vocab = cfg.padded_vocab
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
            continue
        self_us = getattr(ev, "self_device_time_total", 0.0)
        if not self_us:
            continue
        if ev.name.startswith("aten::mm"):
            shapes = [d for s in (ev.input_shapes or []) for d in (s or [])]
            classes["lm_head_gemm" if vocab in shapes else "other_gemm"] += self_us
        elif ev.name.startswith("aten::bmm"):
            first = (ev.input_shapes or [[]])[0] or [0]
            routed = (cfg.family == "moe" and len(first) == 3 and first[0] == n_experts
                      and first[1] % 128 == 0)
            classes["routed_expert_bmm" if routed else "attention_bmm"] += self_us
        elif ev.name.startswith("aten::_foreach"):
            classes["adamw_foreach"] += self_us
    total_us = sum(us for us, _ in per_kernel.values())
    ours = {name: [(us, n) for k, (us, n) in per_kernel.items() if name in k]
            for name in ("sod_matmul", "decompress")}
    wall = statistics.median(walls)
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    log({"phase": "train_profile", "run": run, "arch": cfg.name,
         "what": f"one steady training step, batch {args.batch} × seq {args.seq}, "
                 f"full width, {cfg.n_layers} layers, bf16",
         "step_s_median_of_3": wall, "tok_s": TRAIN_M / wall, "peak_mem_gb": peak,
         "device_ms": total_us / 1e3 if total_us else "not measured",
         "device_idle_share": (1 - total_us / 1e6 / wall) if total_us else "not measured",
         "sod_matmul_ms": sum(us for us, _ in ours["sod_matmul"]) / 1e3,
         "sod_matmul_calls": sum(n for _, n in ours["sod_matmul"]),
         "decompress_ms": sum(us for us, _ in ours["decompress"]) / 1e3,
         "decompress_calls": sum(n for _, n in ours["decompress"]),
         **{f"{k}_ms": (v / 1e3 if any(classes.values()) else "not measured")
            for k, v in classes.items()},
         "launches": {name: mod.launches for name, mod in COUNTERS.items()},
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:15]]})


def phase_train_resume() -> dict:
    """``train_resume``: the reduced model on the card, 12 steps with a
    checkpoint every 5, then two ``--resume --steps 16`` runs on two copies
    of its directory; their losses and final states must be bit-equal.  On a
    mismatch it logs the gradient leaves that differ between two
    computations of one step from the restored state, then fails."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        first = train.main(RESUME_ARGV + ["--steps", "12", "--ckpt-dir", str(tmp / "a")])
        shutil.copytree(tmp / "a", tmp / "b")
        runs = [train.main(RESUME_ARGV + ["--steps", "16", "--resume",
                                          "--ckpt-dir", str(tmp / d)]) for d in "ab"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_losses = runs[0]["losses"] == runs[1]["losses"]
    same_state = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(runs[0]["state"]), leaves_with_path(runs[1]["state"])))
    row = {"phase": "train_resume", "first_losses": first["losses"],
           "start_step": runs[0]["start_step"], "losses": [r["losses"] for r in runs],
           "losses_bit_equal": same_losses, "state_bit_equal": same_state}
    if not (same_losses and same_state):
        state = runs[0]["state"]
        model = LM(configs.reduced(configs.get_config("llama3.2-1b")).with_(
            sod=SoDConfig(mode="tiled_csc", density=DENSITY, min_dim=64)))
        data = SyntheticLMData(model.cfg, 2, 32, seed=0)
        batch = {k: torch.from_numpy(v).long().cuda() for k, v in data.batch(11).items()}
        grads = [steps_mod.make_loss_and_grads(model)(state["params"], batch)[2]
                 for _ in range(2)]
        row["grad_leaves_differing_between_two_replays"] = [
            name for (name, a), (_, b) in zip(leaves_with_path(grads[0]),
                                               leaves_with_path(grads[1]))
            if not torch.equal(a, b)]
    log(row)
    if not (same_losses and same_state):
        raise AssertionError(f"train_resume: two resumes differ: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 9: the rest of the dense family
# ---------------------------------------------------------------------------
# (K, N) -> (what, the output dtype on the model's path: f32 for a head)
FAMILY_SHAPES = {
    "sod_matmul": {(2048, 92544): ("internlm2 head", torch.float32),
                   (7168, 64000): ("yi head", torch.float32),
                   (4608, 36864): ("gemma2 w_gate+w_up", torch.bfloat16),
                   (36864, 4608): ("gemma2 w_down", torch.bfloat16),
                   (20480, 7168): ("yi w_down", torch.bfloat16),
                   (4096, 4608): ("gemma2 wo", torch.bfloat16)},
    "block_matmul": {(7168, 20480): ("yi w_gate+w_up", torch.bfloat16),
                     (20480, 7168): ("yi w_down", torch.bfloat16),
                     (7168, 64000): ("yi head", torch.float32)},
    "decompress": {(36864, 4608): ("gemma2 w_down", None),
                   (7168, 64000): ("yi head", None)},
}
FAMILY_QMODES = {"sod_matmul": ("none", "int8"), "block_matmul": ("none",),
                 "decompress": ("none", "int8")}
FAMILY_BASE = ["--batch", "4", "--prompt-len", "32", "--gen", "16", "--seed", "0",
               "--device", "cuda"]
FAMILY_TILED = ["--sod", "tiled_csc", "--density", str(DENSITY)]
# internlm2 at 4 of its 24 layers, serving and training, for the script's
# time (a 948 s run on an H100 spent 100 s in this phase at 24, another 79 s
# at 8)
INTERNLM2_LAYERS = 4
# cell -> (arch, layers (None: full depth), flags, caller's SoDConfig, kernel,
# qmode)
FAMILY_CELLS = {
    "internlm2_tiled_csc": ("internlm2-1.8b", INTERNLM2_LAYERS, FAMILY_TILED, None,
                            "sod_matmul", "none"),
    "internlm2_tiled_csc_int8": ("internlm2-1.8b", INTERNLM2_LAYERS,
                                 FAMILY_TILED + ["--quantize", "int8"], None,
                                 "sod_matmul", "int8"),
    "gemma2_tiled_csc": ("gemma2-27b", 4, FAMILY_TILED, None, "sod_matmul", "none"),
    "yi_block_csr": ("yi-34b", 4, [], _block_sod(), "block_matmul", "none"),
}
# engine run -> (family cell whose packed weights it serves, speculative)
FAMILY_ENGINE_RUNS = {
    "internlm2_tiled_csc": ("internlm2_tiled_csc", False),
    "internlm2_tiled_csc_spec2": ("internlm2_tiled_csc", True),
    "gemma2_tiled_csc": ("gemma2_tiled_csc", False),
    "gemma2_tiled_csc_spec2": ("gemma2_tiled_csc", True),
    "yi_block_csr": ("yi_block_csr", False),
}
FAMILY_TRAIN_ARGV = ["--arch", "internlm2-1.8b", "--batch", str(TRAIN_BATCH), "--seq",
                     str(TRAIN_SEQ), "--warmup", "2", "--lr", "3e-3", "--seed", "0",
                     "--device", "cuda", "--ckpt-every", "1000", "--log-every", "1000",
                     *FAMILY_TILED]
FAMILY_TRAIN_STEPS = 4


def phase_family_kernels(shapes_by_kernel=None, qmodes=None, seed: int = 4000,
                         phase: str = "family_kernels") -> dict:
    """Each kernel at the shapes a family adds (FAMILY_SHAPES by default),
    in the qmodes of FAMILY_QMODES, bf16 activations: against its plain
    version within KERNEL_TOL (``decompress`` bit for bit), two calls
    bit-equal, its launch plan, and the times of the kernel, its plain
    version and ``torch.matmul`` (with the path's output dtype) on the
    dense bf16 weight beside the bound, at M = 4 and M = 128 (the matmuls).
    One weight is drawn, pruned and packed a (format, K, N), and quantized
    once a qmode, for every kernel that reads it.  Returns the timed rows
    by (kernel, qmode, K, N, M)."""
    shapes_by_kernel = shapes_by_kernel or FAMILY_SHAPES
    qmodes = qmodes or FAMILY_QMODES
    flush = timing.flush_buffer()
    rows = {}
    layouts = sorted({("block" if name == "block_matmul" else "tiled", k, n)
                      for name, shapes in shapes_by_kernel.items() for k, n in shapes})
    for i, (fmt, k, n) in enumerate(layouts):
        x, w = _weights(k, n, max(PATH_M.values()), torch.bfloat16, seed + i,
                        block=fmt == "block")
        packs = {"none": pack_block_csr(w) if fmt == "block" else pack_tiled_csc(w)}
        del w
        for name, shapes in shapes_by_kernel.items():
            if (k, n) not in shapes or (name == "block_matmul") != (fmt == "block"):
                continue
            what, out_dtype = shapes[(k, n)]
            for qmode in qmodes[name]:
                if qmode not in packs:
                    packs[qmode] = quantize_packed(packs["none"], qmode)
                for m in (1,) if name == "decompress" else tuple(PATH_M.values()):
                    rows[(name, qmode, k, n, m)] = _family_kernel_row(
                        name, qmode, what, x[:m].contiguous(), packs[qmode], out_dtype,
                        flush, phase)
        del x, packs
        torch.cuda.empty_cache()
    return rows


def _family_kernel_row(name, qmode, what, x, p, out_dtype, flush,
                       phase: str = "family_kernels") -> dict:
    if name == "decompress":
        kernel, plain = lambda: dk.decompress(p), lambda: ref.decompress_tiled_ref(p)
    else:
        fn = sm.sod_matmul if name == "sod_matmul" else bmm.block_matmul
        kernel = lambda: fn(x, p, out_dtype)               # noqa: E731
        plain = lambda: ref.sod_matmul_ref(x, p, out_dtype)  # noqa: E731
    reset_counts()
    y, y2, yr = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    row = {"phase": phase, "kernel": name, "qmode": qmode, "shape": what,
           "K": p.shape[0], "N": p.shape[1], "M": x.shape[0],
           "out_dtype": str(y.dtype).split(".")[-1], "launches": COUNTERS[name].launches,
           "bit_equal_across_calls": torch.equal(y, y2)}
    if name == "decompress":
        ok = torch.equal(y, yr) and y.dtype == yr.dtype
        row.update(cap=p.cap, bit_equal=ok, dense_bytes=_nbytes(y),
                   plan=dataclasses.asdict(dk.plan_of(p, y.dtype)))
        err = 0.0 if ok else (y.float() - yr.float()).abs().max().item()
    else:
        err = (y.float() - yr.float()).abs().max().item()
        tol = KERNEL_TOL[torch.bfloat16] * yr.float().abs().max().item()
        ok = err <= tol and y.dtype == yr.dtype
        plan = PLANS[name](x, p)
        row.update(max_abs_err=err, tol=tol, bm=plan.bm, m_groups=plan.m_groups,
                   splits=plan.splits, stages=plan.stages, x_tiles=plan.x_tiles,
                   smem_bytes=plan.smem_bytes, ctas_per_sm=plan.ctas_per_sm,
                   **({"cap": p.cap} if name == "sod_matmul" else {"bcap": p.bcap}))
    ok = ok and row["bit_equal_across_calls"] and row["launches"] == 2
    row["max_abs_err"] = err
    if not ok:
        log(row)
        raise AssertionError(f"{name}[{qmode}] at {what} disagrees with its plain "
                             f"version or with itself: {row}")
    del y2, yr
    row["kernel_ms"] = _time_ms(kernel, flush)
    row["plain_ms"] = _time_ms(plain, flush)
    if name == "decompress":
        row["library_ms"] = None
    else:
        dense = p.to_dense().to(torch.bfloat16)
        lib_dtype = out_dtype or x.dtype
        row["library_ms"] = _time_ms(
            lambda: torch.mm(x, dense, out_dtype=lib_dtype) if lib_dtype != x.dtype
            else torch.matmul(x, dense), flush)
        del dense
    row["bound_ms"], row["bound_by"] = _bound(*_work(name, x, p, y), torch.bfloat16)
    log(row)
    return row


@contextlib.contextmanager
def _head_rows():
    """While open, the row count (B·C) of every LM head call is recorded."""
    seen: set[int] = set()
    head = transformer._head

    def counted(params, h, cfg):
        seen.add(h.shape[0] * h.shape[1])
        return head(params, h, cfg)
    transformer._head = counted
    try:
        yield seen
    finally:
        transformer._head = head


def phase_family_serve(cell: str) -> dict:
    """One FAMILY_CELLS cell: its weights prepared at full width (at its
    depth cut through ``prepare(cfg=...)``), served through ``serve.main``
    with every launch count read around the run ((layers · 7 + a packed
    head) × 17 of its kernel, none of the others), then its prefill held
    against the densified weights (the head included); gemma2's logits
    within its final soft-cap."""
    arch, layers, flags, sod, kernel, qmode = FAMILY_CELLS[cell]
    argv = ["--arch", arch, *FAMILY_BASE, *flags]
    args = serve.parse_args(argv)
    full = configs.get_config(arch)
    cfg = full.with_(n_layers=layers) if layers else None
    layers = layers or full.n_layers
    t0 = time.perf_counter()
    model, params, tokens, *_ = serve.prepare(args, sod, cfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    head_packed = isinstance(params.get("head"), (TiledCSC, BlockCSR))
    if head_packed != (not model.cfg.tie_embeddings):
        raise AssertionError(f"{cell}: head packed {head_packed}, tied "
                             f"{model.cfg.tie_embeddings}")
    reset_counts()
    with _head_rows() as head_rows:
        summary = serve.main(argv, sod=sod, prepared=(model, params, tokens))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = (layers * 7 + head_packed) * (1 + 16)
    if launches != expect or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}")
    wb = summary["weight_bytes"]
    if not (summary["logits_finite"] and wb["compressed"] < wb["dense"]):
        raise AssertionError(f"{cell}: non-finite logits or packed bytes not below "
                             f"dense: {summary['logits_finite']}, {wb}")
    packed = {w.qmode for ws in _projections(params).values() for w in ws}
    if packed != {qmode}:
        raise AssertionError(f"{cell}: packed qmodes {packed}, want {qmode}")
    log({"phase": "family", "cell": cell, "arch": arch, "layers": layers,
         "depth_cut": f"{full.n_layers} -> {layers}" if layers != full.n_layers else None,
         "qmode": qmode, "head_packed": head_packed, "head_rows": sorted(head_rows),
         "pack_s": pack_s, "launches": launches,
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "sample": summary["sample"], "weight_bytes": wb})
    row = check_vs_dense(cell, model, params, tokens, kernel, layers)
    cap = model.cfg.final_softcap
    if cap is not None:
        peak = row["logits"].abs().max().item()
        with torch.inference_mode():
            _, cache, pos = serve.prefill_cache(model, params, tokens, 40)
            step, _ = model.decode_step(params, cache, tokens[:, -1:], pos)
        peak = max(peak, step[..., :model.cfg.vocab].abs().max().item())
        log({"phase": "family", "cell": cell, "final_softcap": cap,
             "max_abs_logit": peak})
        if not peak <= cap:
            raise AssertionError(f"{cell}: |logit| {peak} above the soft-cap {cap}")
    return {"launches": launches[kernel], "model": model, "params": params,
            "tokens": tokens, "decompress_launches": row["decompress_launches"]}


def phase_family_head(sl: dict) -> None:
    """The model's untied head alone at the engine's decode rows (M = 4):
    one ``_head`` call timed as phase 3 times a kernel, beside its bound."""
    model, params = sl["model"], sl["params"]
    head = params["head"]
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    h = torch.randn(4, 1, model.cfg.d_model, generator=g, device="cuda").bfloat16()
    with torch.inference_mode():
        ms = _time_ms(lambda: transformer._head(params, h, model.cfg),
                      timing.flush_buffer())
        y = transformer._head(params, h, model.cfg)
    log({"phase": "family_head", "arch": model.cfg.name, "M": 4, "K": head.shape[0],
         "N": head.shape[1], "ms": ms,
         "bound_ms": _bound(*_work("sod_matmul", h[:, 0], head, y[:, 0]),
                            torch.bfloat16)[0]})


def phase_family_engine(run: str, cells: dict) -> dict:
    """One engine run through ``serve.main --engine`` on a family cell's
    packed weights (with ``--spec-decode 2 --draft-sparsity 0.88`` for a
    spec run), every request held against ``static_generate`` bit for bit;
    the cell's kernel launched and the other not; an untied head run at one
    row (static) and at the engine's 4 (and 4 × 3 in a window)."""
    cell, spec = FAMILY_ENGINE_RUNS[run]
    arch, _, _, _, kernel, _ = FAMILY_CELLS[cell]
    sl = cells[cell]
    model, params = sl["model"], sl["params"]
    argv = (["--arch", arch] + ENGINE_ARGV[2:]
            + (["--spec-decode", "2", "--draft-sparsity", str(DRAFT_SPARSITY)]
               if spec else []))
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    reset_counts()
    with _head_rows() as head_rows:
        summary = serve.main(argv, prepared=(model, params, sl["tokens"]))
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        trace, tokens = summary["trace"], summary["tokens"]
        if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
            raise AssertionError(f"engine {run}: {summary['completed']} of "
                                 f"{len(trace)} requests completed")
        static_s = _check_tokens(run, model, params, trace, tokens)
    want_rows = {1, 4} | ({12} if spec else set())
    untied = not model.cfg.tie_embeddings
    if not (launches[kernel] > 0 and launches[other] == 0 and launches["decompress"] == 0
            and summary["logits_finite"]
            and (not untied or want_rows <= head_rows)
            and (not spec or summary["spec_windows"] >= 1)):
        raise AssertionError(f"engine {run}: launches {launches}, head rows "
                             f"{sorted(head_rows)}, finite {summary['logits_finite']}, "
                             f"spec windows {summary.get('spec_windows')}")
    row = {"phase": "family_engine", "run": run, "cell": cell, "launches": launches[kernel],
           "head_rows": sorted(head_rows), "bit_equal_to_static_generate": True,
           "static_generate_s": static_s,
           **{k: summary[k] for k in (
               "completed", "steps", "generated_tokens", "warmup_s", "steady_tok_per_s",
               "p50_latency_s", "p99_latency_s", "step_ms_p50", "step_ms_p99",
               "logits_finite") if k in summary},
           **({k: summary[k] for k in ("spec_windows", "acceptance_rate", "draft_density",
                                       "draft_bytes")} if spec else {})}
    log(row)
    return row


def phase_family_train() -> dict:
    """``train_internlm2``: full-width internlm2-1.8b at INTERNLM2_LAYERS,
    tiled_csc 0.3, batch 8 × seq 128, remat on, FAMILY_TRAIN_STEPS steps.  First the packed
    head's gradient at M = 1024 with float32 out, through the kernel's
    autograd.Function against autograd over the plain version (GRAD_TOL,
    exact 0 at padding).  Then ``train.main``, gated on finite losses and
    gradient norms, integer leaves bit-equal to the initial pack, padding
    exactly 0 (the head's too), only ``cuda_fused`` dispatched, and the
    launches: 2 × 28 projections (remat) + the head a step of
    ``sod_matmul``, 29 a step of ``decompress``.  Then one steady step is
    profiled."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_internlm2_")
    argv = FAMILY_TRAIN_ARGV + ["--steps", str(FAMILY_TRAIN_STEPS), "--ckpt-dir", tmp]
    try:
        t0 = time.perf_counter()
        prep = train.prepare(train.parse_args(argv), configs.get_config(
            "internlm2-1.8b").with_(n_layers=INTERNLM2_LAYERS))
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        head = prep[1]["head"]
        g = torch.Generator(device="cuda")
        g.manual_seed(3100)
        x = torch.randn(TRAIN_M, head.shape[0], generator=g, device="cuda").bfloat16()
        cot = torch.randn(TRAIN_M, head.shape[1], generator=g, device="cuda")
        got = _backward(x, head, cot, True, torch.float32)
        want = _backward(x, head, cot, False, torch.float32)
        torch.cuda.synchronize()
        errs = {}
        for leaf, b in want.items():
            a = got[leaf]
            errs[leaf] = (a.float() - b.float()).abs().max().item()
            if a.dtype != b.dtype or errs[leaf] > GRAD_TOL[b.dtype] * b.float().abs().max().item():
                raise AssertionError(f"train_internlm2: head d{leaf} off by {errs[leaf]} "
                                     f"({a.dtype} vs {b.dtype})")
        if not bool((got["vals"][head.rows < 0] == 0).all()):
            raise AssertionError("train_internlm2: the head's padding got a gradient")
        log({"phase": "family_train_grads", "K": head.shape[0], "N": head.shape[1],
             "M": TRAIN_M, "out_dtype": "float32", "max_abs_err": errs,
             "padding_exact_zero": True})
        del got, want, x, cot
        ints = {k: v.clone() for k, v in leaves_with_path(prep[1])
                if not v.is_floating_point()}
        n_layers_packed, cfg = len(_packed(prep[1])), prep[0].cfg
        reset_counts()
        summary = train.main(argv, prepared=prep)
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        del prep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    params = summary["state"]["params"]
    losses, gnorms = summary["losses"], summary["grad_norms"]
    remat = 2 if cfg.remat else 1
    want_launches = {"sod_matmul": (remat * n_layers_packed + 1) * FAMILY_TRAIN_STEPS,
                     "block_matmul": 0,
                     "decompress": (n_layers_packed + 1) * FAMILY_TRAIN_STEPS}
    final_ints = {k: v for k, v in leaves_with_path(params) if not v.is_floating_point()}
    gates = {
        "finite": all(map(math.isfinite, losses + gnorms)),
        "integer_leaves_bit_equal": final_ints.keys() == ints.keys() and all(
            torch.equal(v, ints[k]) for k, v in final_ints.items()),
        "padding_exact_zero": all(bool((w.vals[w.rows < 0] == 0).all())
                                  for w in _packed(params) + [params["head"]]),
        "head_packed": isinstance(params["head"], TiledCSC),
        "dispatch_only_cuda_fused": bool(summary["kernel_dispatch"]) and all(
            k.startswith("cuda_fused[") for k in summary["kernel_dispatch"]),
        "launches": launches == want_launches
        and summary["kernel_launches"] == want_launches,
    }
    row = {"phase": "family_train", "run": "train_internlm2", "layers": cfg.n_layers,
           "steps": FAMILY_TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "prepare_s": prepare_s,
           "losses": losses, "grad_norms": gnorms, "launches": launches,
           "launches_want": want_launches, "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
           "checkpoints": summary["checkpoints"], "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"train_internlm2: a gate failed: {gates}")
    phase_train_profile(summary, "train_internlm2", argv, INTERNLM2_LAYERS)
    return {"launches": launches, "head_grad_err": max(errs.values())}


def phase_family(timed) -> dict:
    """Phase 9: the kernels at the family's shapes, then each cell, its
    engine runs and training, each freed before the next; every step
    through ``timed(phase, fn, *args)``, which records its seconds."""
    out = {"kernels": timed("family:kernels", phase_family_kernels), "launches": {},
           "engine": {}}
    cells = {}
    for cell in FAMILY_CELLS:
        sl = cells[cell] = timed(f"family:{cell}", phase_family_serve, cell)
        out["launches"][cell] = {k: sl[k] for k in ("launches", "decompress_launches")}
        if cell == "internlm2_tiled_csc":
            timed("family:profile", phase_profile, cell, sl["model"], sl["params"],
                  sl["tokens"])
            timed("family:profile", phase_family_head, sl)
        for run, (of, _) in FAMILY_ENGINE_RUNS.items():
            if of == cell:
                out["engine"][run] = timed(f"family:engine:{run}", phase_family_engine,
                                           run, cells)
        for key in ("model", "params", "tokens"):
            sl.pop(key)
        torch.cuda.empty_cache()
        if cell == "internlm2_tiled_csc_int8":
            out["train"] = timed("family:train", phase_family_train)
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: the MoE family
# ---------------------------------------------------------------------------
# (K, N) -> (what, the output dtype on the model's path); qwen's attention
# projections are llama's 2048 x 2048 (phase 3)
MOE_SHAPES = {
    "sod_matmul": {(1024, 1024): ("granite wq+wo", torch.bfloat16),
                   (1024, 512): ("granite wk+wv", torch.bfloat16),
                   (2048, 5632): ("qwen shared w_gate+w_up", torch.bfloat16),
                   (5632, 2048): ("qwen shared w_down", torch.bfloat16),
                   (2048, 151936): ("qwen head", torch.float32)},
    "block_matmul": {(1024, 1024): ("granite wq+wo", torch.bfloat16),
                     (1024, 512): ("granite wk+wv", torch.bfloat16)},
    "decompress": {(1024, 1024): ("granite wq+wo", None),
                   (1024, 512): ("granite wk+wv", None),
                   (2048, 151936): ("qwen head", None)},
}
MOE_QMODES = {"sod_matmul": ("none",), "block_matmul": ("none",), "decompress": ("none",)}
# cell -> (arch, flags, caller's SoDConfig, kernel, packed projections a layer)
# both models at 4 of their 24 layers (as phase 15's mesh cell), serving
# and training, for the script's time (a 948 s run on an H100 spent 119 s
# in this phase at 24, another 61 s at 8)
MOE_LAYERS = 4
MOE_CELLS = {
    "granite_moe_tiled_csc": ("granite-moe-1b-a400m", FAMILY_TILED, None, "sod_matmul", 4),
    "granite_moe_block_csr": ("granite-moe-1b-a400m", ["--sod", "block_csr"], _block_sod(),
                              "block_matmul", 4),
    "qwen2_moe_tiled_csc": ("qwen2-moe-a2.7b", FAMILY_TILED, None, "sod_matmul", 7),
}
# engine run -> (MoE cell whose packed weights and plan it serves, prefill chunk)
MOE_ENGINE_RUNS = {"granite_moe": ("granite_moe_tiled_csc", None),
                   "granite_moe_chunk16": ("granite_moe_tiled_csc", 16),
                   "qwen2_moe": ("qwen2_moe_tiled_csc", None)}
MOE_TRAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--batch", str(TRAIN_BATCH), "--seq",
                  str(TRAIN_SEQ), "--warmup", "2", "--lr", "3e-3", "--seed", "0",
                  "--device", "cuda", "--ckpt-every", "1000", "--log-every", "1000",
                  *FAMILY_TILED]
MOE_TRAIN_STEPS = 4
# aten operators of the MoE block's dispatch: the rank sort, the scatter into
# the capacity buffer, the gathers back, the routing's top-k sort
DISPATCH_OPS = ("aten::sort", "aten::index_put", "aten::index_put_", "aten::index",
                "aten::gather", "aten::scatter", "aten::scatter_", "aten::scatter_add_",
                "aten::cumsum", "aten::bincount")


def _moe_plan(label: str, cfg, sod: SoDConfig, seed: int, m_values, tmp: str) -> tuple:
    """The port's planner on the seeded raw weights of ``cfg`` (drawn as
    ``serve.prepare`` and ``train.prepare`` draw them), the routed experts'
    entries dropped (``moe.without_routed``), saved under ``tmp``.  Returns
    (path, plan row)."""
    cfg = cfg.with_(sod=sod)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    raw = LM(cfg).init(gen, "cuda")
    full = planner.build_plan(raw, sod, cfg=cfg, cache=autotune.get_cache(),
                              m_values=tuple(m_values))
    del raw
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    e = transformer.moe_spec(cfg).n_experts_padded
    leads = {p: full.entries[p].lead for p in moe.ROUTED_PATHS}
    if set(leads.values()) != {(cfg.n_layers, 1, e)}:
        raise AssertionError(f"{label}: routed experts planned with leads {leads}, "
                             f"want {(cfg.n_layers, 1, e)}")
    plan = moe.without_routed(full)
    path = str(plan.save(pathlib.Path(tmp) / f"{label}.json"))
    row = {"plan_s": plan_s, "entries_planned": len(full), "entries_kept": len(plan),
           "routed_leads": {p: list(v) for p, v in leads.items()},
           "modes": {p: e.mode for p, e in plan.entries.items()}}
    return path, row


def phase_moe_serve(cell: str, tmp: str) -> dict:
    """One MOE_CELLS cell at full width and MOE_LAYERS: its plan built on the
    seeded raw weights with the routed entries dropped, the weights
    prepared under ``--plan P`` (routed experts dense, the rest packed),
    served through ``serve.main`` with every launch count read around the
    run ((layers · packed a layer + a packed head) × 17 of its kernel, none
    of the others, no ``torch_oracle`` dispatch), then its prefill held
    against the densified weights."""
    arch, flags, sod, kernel, per_layer = MOE_CELLS[cell]
    base = ["--arch", arch, *FAMILY_BASE, *flags]
    args = serve.parse_args(base)
    cfg = configs.get_config(arch).with_(n_layers=MOE_LAYERS)
    plan_path, plan_row = _moe_plan(
        cell, cfg, sod or SoDConfig(mode=args.sod, density=args.density, min_dim=64),
        args.seed, serve.m_values(args, cfg), tmp)
    argv = base + ["--plan", plan_path]
    t0 = time.perf_counter()
    prep = serve.prepare(serve.parse_args(argv), sod, cfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    model, params, tokens, plan = prep[:4]
    layers = model.cfg.n_layers
    head_packed = isinstance(params.get("head"), (TiledCSC, BlockCSR))
    routed_dense = all(isinstance(layer["moe"][n], torch.Tensor)
                       for layer in params["layers"] for n in moe.ROUTED)
    packed_a_layer = {len(_packed_paths(layer)) for layer in params["layers"]}
    if not (routed_dense and packed_a_layer == {per_layer}
            and head_packed == (not model.cfg.tie_embeddings)):
        raise AssertionError(f"{cell}: routed experts dense {routed_dense}, packed a "
                             f"layer {packed_a_layer} (want {per_layer}), head packed "
                             f"{head_packed}")
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=(model, params, tokens, plan))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = (layers * per_layer + head_packed) * (1 + 16)
    oracle = [k for k in summary["kernel_dispatch"] if k.startswith("torch_oracle")]
    if launches != expect or oracle or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}; "
                             f"dispatch {summary['kernel_dispatch']}")
    wb = summary["weight_bytes"]
    if not summary["logits_finite"]:
        raise AssertionError(f"{cell}: non-finite logits from the full-width serve")
    log({"phase": "moe", "cell": cell, "arch": arch, "layers": layers,
         "plan": plan_row, "pack_s": pack_s, "launches": launches,
         "kernel_dispatch": summary["kernel_dispatch"], "head_packed": head_packed,
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "sample": summary["sample"], "weight_bytes": wb})
    row = check_vs_dense(cell, model, params, tokens, kernel, layers, per_layer)
    return {"launches": launches[kernel], "decompress_launches": row["decompress_launches"],
            "model": model, "params": params, "tokens": tokens, "plan": plan}


def phase_moe_engine(run: str, cells: dict) -> dict:
    """One engine run through ``serve.main --engine`` on an MoE cell's packed
    weights under its plan, over phase 6's trace (4 slots, 16-token pages):
    every request equal to ``static_generate`` under the same plan bit for
    bit, the cell's kernel launched and the others not, no ``torch_oracle``
    dispatch, finite logits and a clean pool after the run."""
    cell, chunk = MOE_ENGINE_RUNS[run]
    arch, _, _, kernel, _ = MOE_CELLS[cell]
    sl = cells[cell]
    model, params, plan = sl["model"], sl["params"], sl["plan"]
    argv = (["--arch", arch] + ENGINE_ARGV[2:]
            + (["--prefill-chunk", str(chunk)] if chunk else []))
    reset_counts()
    with _engine_probe(params) as seen:
        summary = serve.main(argv, prepared=(model, params, sl["tokens"], plan))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    (eng,) = seen["engines"]
    trace, tokens = summary["trace"], summary["tokens"]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    oracle = [k for k in summary["kernel_dispatch"] if k.startswith("torch_oracle")]
    if not (launches[kernel] > 0 and launches[other] == 0 and launches["decompress"] == 0
            and not oracle and summary["logits_finite"]):
        raise AssertionError(f"engine {run}: launches {launches}, dispatch "
                             f"{summary['kernel_dispatch']}, finite "
                             f"{summary['logits_finite']}")
    if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {summary['completed']} of "
                             f"{len(trace)} requests completed")
    pool = eng.page_pool
    if pool.free_count != pool.n_pages - 1 or pool.allocated:
        raise AssertionError(f"engine {run}: pool not clean: {pool.free_count} of "
                             f"{pool.n_pages - 1} free")
    static_s = _check_tokens(run, model, params, trace, tokens, plan=plan)
    row = {"phase": "moe_engine", "run": run, "cell": cell, "prefill_chunk": chunk,
           "launches": launches[kernel], "kernel_dispatch": summary["kernel_dispatch"],
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           "pool_clean": True,
           **{k: summary[k] for k in (
               "completed", "steps", "generated_tokens", "warmup_s", "steady_tok_per_s",
               "p50_latency_s", "p99_latency_s", "step_ms_p50", "step_ms_p99",
               "logits_finite") if k in summary}}
    log(row)
    return row


def phase_moe_profile(sl: dict) -> None:
    """One steady static decode step of qwen2-moe-a2.7b (batch 4) under its
    plan, under ``torch.profiler``: device ms by kernel and by class (the
    SoD kernels; the routed experts' products, ``aten::bmm`` over the E
    padded experts; the MoE dispatch's sort, scatter and gathers
    (DISPATCH_OPS); attention's other ``aten::bmm``; the dense GEMMs of
    the router and the shared gate), and the idle share against the median
    wall of 7 unprofiled steps.  The routed products read every expert's
    weights at decode (capacity 128 slots an expert), and their byte bound
    is logged beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, params, tokens, plan = sl["model"], sl["params"], sl["tokens"], sl["plan"]
    cfg = model.cfg
    spec = transformer.moe_spec(cfg)
    decode = steps_mod.make_decode_step(model, plan=plan)
    with torch.inference_mode():
        _, cache, pos = serve.prefill_cache(model, params, tokens, 48, plan=plan)
        tok = torch.zeros((tokens.shape[0], 1), dtype=torch.long, device="cuda")
        decode(params, cache, tok, pos)
        step_ms = []
        for t in range(1, 8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(params, cache, tok, pos + t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            decode(params, cache, tok, pos + 8)
            torch.cuda.synchronize()
    per_kernel: dict[str, tuple[float, int]] = {}
    classes = {"routed_expert_bmm": 0.0, "dispatch": 0.0, "attention_bmm": 0.0,
               "dense_gemm": 0.0}
    calls = dict.fromkeys(classes, 0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
            continue
        self_us = getattr(ev, "self_device_time_total", 0.0)
        if not self_us:
            continue
        cls = None
        if ev.name == "aten::bmm":
            # the experts' products are (E, blocks · capacity, d_model or d_ff)
            # @ (E, ., .); attention's batch is rows × KV heads, which qwen's
            # 4 × 16 makes E too, so the trailing dims tell them apart
            first = (ev.input_shapes or [[]])[0] or [0]
            routed = (len(first) == 3 and first[0] == spec.n_experts_padded
                      and first[1] % 128 == 0 and first[2] in (spec.d_model, spec.d_ff))
            cls = "routed_expert_bmm" if routed else "attention_bmm"
        elif ev.name in DISPATCH_OPS:
            cls = "dispatch"
        elif ev.name == "aten::mm":
            cls = "dense_gemm"
        if cls:
            classes[cls] += self_us
            calls[cls] += 1
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    sod_us = sum(us for k, (us, _) in per_kernel.items()
                 if "sod_matmul" in k or "block_matmul" in k)
    step = statistics.median(step_ms)
    expert_bytes = 3 * spec.n_experts_padded * spec.d_model * spec.d_ff * 2 * cfg.n_layers
    measured = bool(rows)
    log({"phase": "moe_profile", "cell": "qwen2_moe_tiled_csc", "arch": cfg.name,
         "what": f"one static decode step, batch 4, full width, {cfg.n_layers} layers, "
                 "bf16",
         "step_ms_median_of_7": step,
         "device_ms": total_ms if measured else "not measured",
         "device_idle_share": (1 - total_ms / step) if measured else "not measured",
         "sod_kernels_ms": sod_us / 1e3 if measured else "not measured",
         **{f"{k}_ms": (v / 1e3 if any(classes.values()) else "not measured")
            for k, v in classes.items()},
         "calls": calls,
         "routed_expert_bytes_a_step": expert_bytes,
         "routed_expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:15]]})


def phase_moe_train(tmp: str) -> dict:
    """``train_granite``: full-width granite-moe-1b-a400m at MOE_LAYERS under a
    plan without routed entries (built on the seed's raw weights), batch 8
    × seq 128, remat on, MOE_TRAIN_STEPS steps, gated on finite losses,
    gradient norms and router aux losses, every aux loss above 0, integer
    leaves bit-equal to the initial pack, the routed experts still dense,
    only ``cuda_fused`` dispatched, and the launches: 2 × 16 packed
    attention projections (remat) of ``sod_matmul`` and 16 of
    ``decompress`` a step; then one steady step is profiled."""
    ck = tempfile.mkdtemp(prefix="chip_smoke_train_granite_")
    args = train.parse_args(MOE_TRAIN_ARGV)
    cfg = configs.get_config(args.arch).with_(n_layers=MOE_LAYERS)
    plan_path, plan_row = _moe_plan(
        "train_granite", cfg, SoDConfig(mode=args.sod, density=args.density, min_dim=64),
        args.seed, (TRAIN_M,), tmp)
    argv = MOE_TRAIN_ARGV + ["--plan", plan_path, "--steps", str(MOE_TRAIN_STEPS),
                             "--ckpt-dir", ck]
    try:
        t0 = time.perf_counter()
        prep = train.prepare(train.parse_args(argv), cfg)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        ints = {k: v.clone() for k, v in leaves_with_path(prep[1])
                if not v.is_floating_point()}
        n_packed, train_cfg = len(_packed(prep[1])), prep[0].cfg
        reset_counts()
        summary = train.main(argv, prepared=prep)
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        del prep
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    params = summary["state"]["params"]
    losses, gnorms, auxes = summary["losses"], summary["grad_norms"], summary["aux_losses"]
    remat = 2 if train_cfg.remat else 1
    want = {"sod_matmul": remat * n_packed * MOE_TRAIN_STEPS, "block_matmul": 0,
            "decompress": n_packed * MOE_TRAIN_STEPS}
    final_ints = {k: v for k, v in leaves_with_path(params) if not v.is_floating_point()}
    gates = {
        "attention_packed": n_packed == MOE_CELLS["granite_moe_tiled_csc"][4] * train_cfg.n_layers,
        "finite": all(map(math.isfinite, losses + gnorms + auxes)),
        "aux_positive": all(a > 0 for a in auxes),
        "integer_leaves_bit_equal": final_ints.keys() == ints.keys() and all(
            torch.equal(v, ints[k]) for k, v in final_ints.items()),
        "routed_experts_dense": all(isinstance(layer["moe"][n], torch.Tensor)
                                    for layer in params["layers"] for n in moe.ROUTED),
        "dispatch_only_cuda_fused": bool(summary["kernel_dispatch"]) and all(
            k.startswith("cuda_fused[") for k in summary["kernel_dispatch"]),
        "launches": launches == want and summary["kernel_launches"] == want,
    }
    row = {"phase": "moe_train", "run": "train_granite", "layers": train_cfg.n_layers,
           "steps": MOE_TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "plan": plan_row,
           "prepare_s": prepare_s, "losses": losses, "aux_losses": auxes,
           "grad_norms": gnorms, "launches": launches, "launches_want": want,
           "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
           "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"train_granite: a gate failed: {gates}")
    phase_train_profile(summary, "train_granite", MOE_TRAIN_ARGV, MOE_LAYERS)
    return {"launches": launches}


def phase_moe(timed) -> dict:
    """Phase 10: the kernels at the MoE shapes, each cell with its engine
    runs (qwen's decode step profiled), each freed before the next, then
    ``train_granite``; every step through ``timed``.  Plans are written to a
    temporary directory, deleted at the end."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        out = {"kernels": timed("moe:kernels", phase_family_kernels, MOE_SHAPES, MOE_QMODES,
                                6000, "moe_kernels"),
               "launches": {}, "engine": {}}
        cells = {}
        for cell in MOE_CELLS:
            sl = cells[cell] = timed(f"moe:{cell}", phase_moe_serve, cell, tmp)
            out["launches"][cell] = {k: sl[k] for k in ("launches", "decompress_launches")}
            for run, (of, _) in MOE_ENGINE_RUNS.items():
                if of == cell:
                    out["engine"][run] = timed(f"moe:engine:{run}", phase_moe_engine,
                                               run, cells)
            if cell == "qwen2_moe_tiled_csc":
                timed("moe:profile", phase_moe_profile, sl)
            for key in ("model", "params", "tokens", "plan"):
                sl.pop(key)
            torch.cuda.empty_cache()
        out["train"] = timed("moe:train", phase_moe_train, tmp)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _moe_entry(name: str, qmode: str, moe_out: dict) -> dict:
    """Phase 10's numbers of one kernel in one qmode: its launches in each
    MoE cell, engine run and ``train_granite`` (counted from 0 around each
    run), and its rows at the MoE shapes."""
    if qmode != "none":
        return {}
    launches = {}
    for cell, (_, _, _, kernel, _) in MOE_CELLS.items():
        if name == kernel:
            launches[cell] = moe_out["launches"][cell]["launches"]
        elif name == "decompress" and kernel == "sod_matmul":
            launches[f"{cell}:densified"] = moe_out["launches"][cell]["decompress_launches"]
    launches.update({f"engine:{run}": row["launches"] for run, row in moe_out["engine"].items()
                     if MOE_CELLS[row["cell"]][3] == name})
    if name != "block_matmul":
        launches["train_granite"] = moe_out["train"]["launches"][name]
    rows = [r for (kn, q, *_), r in moe_out["kernels"].items() if kn == name and q == qmode]
    return {"moe_launches": launches,
            "moe_shapes": [{k: r[k] for k in ("shape", "K", "N", "M", "out_dtype",
                                              "max_abs_err", "kernel_ms", "plain_ms",
                                              "library_ms", "bound_ms", "bound_by")}
                           for r in rows]}


def _entry(name: str, qmode: str, kern: dict, launches: int) -> dict:
    """One kernel's line in one qmode: the seven projections of one layer
    (M = 4 at decode for the matmuls, and M = 128 at prefill beside it),
    bf16 activations, summed from the per-shape medians."""
    def layer(tag: str) -> tuple[list, dict]:
        rows = [(row, PATH_SHAPES[(k, n)][1])
                for (kn, q, k, n, t), row in kern["timed"].items()
                if kn == name and q == qmode and t == tag]
        keys = ("kernel_ms", "plain_ms", "bound_ms") + (
            () if name == "decompress" and qmode != "none" else ("library_ms",))
        return rows, {key: sum(r[key] * c for r, c in rows) for key in keys}

    rows, total = layer("path" if name == "decompress" else "decode")
    lib = total.get("library_ms")
    prefill = {} if name == "decompress" else layer("prefill")[1]
    source, replaces = SOURCES[name]
    out = "float32" if qmode != "none" else "bf16"
    return {
        "name": name if qmode == "none" else f"{name}[{qmode}]",
        "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": kern["max_err"][(name, qmode)],
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in rows)
        else "operations",
        "library_ms": lib,
        "prefill_ms": prefill.get("kernel_ms"),
        "prefill_library_ms": prefill.get("library_ms"),
        "prefill_bound_ms": prefill.get("bound_ms"),
        "work": (f"one layer's 7 projections densified ({out} out), summed"
                 if name == "decompress" else
                 "one layer's 7 projections at decode (M=4, bf16), summed; "
                 "prefill_*: the same at M=128"),
    }


def _launches_of(name: str, qmode: str, cells: dict, kern: dict) -> tuple[int, str]:
    """(launches, where): from the cell that serves the kernel in this qmode
    (or, for decompress, densifies its weights), else from phase 3."""
    for cell, (_, _, kernel, q, _) in CELLS.items():
        if q != qmode:
            continue
        if name == kernel:
            return cells[cell]["launches"], cell
        if name == "decompress" and kernel == "sod_matmul":
            return cells[cell]["decompress_launches"], cell
    return kern["launches"][(name, qmode)], "phase 3"


def _family_entry(name: str, qmode: str, family: dict) -> dict:
    """Phase 9's numbers of one kernel in one qmode: its launches in each
    family cell and engine run that serves it (counted from 0 around each
    run), in ``train_internlm2``, and its rows at the family's shapes."""
    out = {}
    launches = {}
    for cell, (_, _, _, _, kernel, q) in FAMILY_CELLS.items():
        if q != qmode:
            continue
        if name == kernel:
            launches[cell] = family["launches"][cell]["launches"]
        elif name == "decompress" and kernel == "sod_matmul":
            launches[f"{cell}:densified"] = family["launches"][cell]["decompress_launches"]
    if qmode == "none":
        launches.update({f"engine:{run}": row["launches"]
                         for run, row in family["engine"].items()
                         if FAMILY_CELLS[row["cell"]][4] == name})
        if name != "block_matmul":
            launches["train_internlm2"] = family["train"]["launches"][name]
    if launches:
        out["family_launches"] = launches
    rows = [r for (kn, q, *_), r in family["kernels"].items() if kn == name and q == qmode]
    if rows:
        out["family_shapes"] = [
            {k: r[k] for k in ("shape", "K", "N", "M", "out_dtype", "max_abs_err",
                               "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")} for r in rows]
    if name == "sod_matmul" and qmode == "none":
        out["family_head_grad_max_abs_err"] = family["train"]["head_grad_err"]
    return out

# ---------------------------------------------------------------------------
# phase 11: the recurrent families
# ---------------------------------------------------------------------------
# (K, N) -> (what, the output dtype on the model's path)
RECURRENT_SHAPES = {
    "sod_matmul": {(2560, 5120): ("zamba2 w_z+w_x", torch.bfloat16),
                   (5120, 2560): ("zamba2 out_proj", torch.bfloat16),
                   (2560, 10240): ("zamba2 shared w_gate+w_up", torch.bfloat16),
                   (2560, 32000): ("zamba2 head", torch.float32),
                   (1536, 1536): ("xlstm wq+wk+wv", torch.bfloat16),
                   (768, 3072): ("xlstm w_up", torch.bfloat16),
                   (768, 50304): ("xlstm head", torch.float32)},
    "block_matmul": {(2560, 5120): ("zamba2 w_z+w_x", torch.bfloat16),
                     (5120, 2560): ("zamba2 out_proj", torch.bfloat16),
                     (2560, 32000): ("zamba2 head", torch.float32)},
    "decompress": {(2560, 5120): ("zamba2 w_z+w_x", None),
                   (5120, 2560): ("zamba2 out_proj", None),
                   (1536, 1536): ("xlstm wq+wk+wv", None)},
}
RECURRENT_QMODES = {"sod_matmul": ("none", "int8"), "block_matmul": ("none",),
                    "decompress": ("none",)}
# cell -> (arch, layers (None: full depth), flags, caller's SoDConfig, kernel)
# zamba2 at one of its nine groups, xlstm at one of its
# three, full width: every shape of the model runs, and the phase's time
# (the engine replays every prompt through the decode step) keeps the
# script near half its limit
RECURRENT_CELLS = {
    "zamba2_tiled_csc": ("zamba2-2.7b", 6, FAMILY_TILED, None, "sod_matmul"),
    "zamba2_block_csr": ("zamba2-2.7b", 6, [], _block_sod(), "block_matmul"),
    "xlstm_tiled_csc": ("xlstm-125m", 4, FAMILY_TILED, None, "sod_matmul"),
}
RECURRENT_ENGINE_RUNS = {"zamba2_tiled_csc": "zamba2_tiled_csc",
                         "xlstm_tiled_csc": "xlstm_tiled_csc"}
# run -> (arch, layers (None: full depth)); both at full width and one
# group, for the script's time: xlstm at 4 of its 12 layers (one
# mLSTM-sLSTM group; 59 s at 12 and 32 s at 8 on an H100; phase 13 trains
# it at full depth), zamba2 at 6 of its 54 (one Mamba2 group and one
# application of the shared block, as its cells)
RECURRENT_TRAIN_RUNS = {"train_xlstm": ("xlstm-125m", 4),
                        "train_zamba2": ("zamba2-2.7b", 6)}
RECURRENT_TRAIN_STEPS = 4
# a recurrent cell replays its 32-token prompt through the decode step, then
# decodes 16 tokens: 48 decode steps, each running every packed projection
# once (the hybrid's shared block once an application)
RECURRENT_DECODE_STEPS = 32 + 16


def _recurrent_per_step(cfg) -> int:
    """Packed projections one forward runs, from the config: the hybrid's
    3 a Mamba2 block (w_z, w_x, out_proj), 7 a shared-block application
    (wq, wk, wv, wo, w_gate, w_up, w_down; one every hybrid_attn_every
    blocks) and the head; the xLSTM's 5 an mLSTM block (w_up, wq, wk, wv,
    w_down; sLSTM's gates stay dense) and the head."""
    if cfg.family == "hybrid":
        return cfg.n_layers * 3 + cfg.n_layers // cfg.hybrid_attn_every * 7 + 1
    return cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1) * 5 + 1


def _recurrent_packed(params) -> dict[str, list]:
    """The packed leaves of a recurrent tree by path: each stack's
    (``mamba_blocks.mamba.w_z``: one a block), the shared block's and the
    head."""
    out = {}
    for key, v in params.items():
        if isinstance(v, list):
            blocks = sod_mod._flat(v)[0]
            out.update({f"{key}.{p}": [_at(b, p) for b in blocks]
                        for p in _packed_paths(blocks[0])})
        elif isinstance(v, dict):
            out.update({f"{key}.{p}": [_at(v, p)] for p in _packed_paths(v)})
        elif isinstance(v, (TiledCSC, BlockCSR)):
            out[key] = [v]
    return out


def _runs_a_step(params, cfg) -> int:
    """Packed projections one forward runs, counted on the packed tree."""
    apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    return sum(len(ws) * (apps if path.startswith("shared_attn.") else 1)
               for path, ws in _recurrent_packed(params).items())


def phase_recurrent_serve(cell: str) -> dict:
    """One RECURRENT_CELLS cell at full width: its weights prepared (at its
    depth cut through ``prepare(cfg=...)``), served through ``serve.main``
    with every launch count read around the run (the prompt replayed
    through the decode step: _recurrent_per_step × 48 launches of its
    kernel, none of the others, no ``torch_oracle`` dispatch), then its
    last prompt position's logits held against the densified weights'
    (both through the serve path: the prompt stepped through the decode
    step)."""
    arch, layers, flags, sod, kernel = RECURRENT_CELLS[cell]
    argv = ["--arch", arch, *FAMILY_BASE, *flags]
    args = serve.parse_args(argv)
    full = configs.get_config(arch)
    t0 = time.perf_counter()
    model, params, tokens, *_ = serve.prepare(
        args, sod, full.with_(n_layers=layers) if layers else None)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    cfg = model.cfg
    per_step = _recurrent_per_step(cfg)
    if _runs_a_step(params, cfg) != per_step or not isinstance(params["head"],
                                                               (TiledCSC, BlockCSR)):
        raise AssertionError(f"{cell}: {_runs_a_step(params, cfg)} packed projections a "
                             f"step, want {per_step}; head {type(params['head'])}")
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=(model, params, tokens))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = per_step * RECURRENT_DECODE_STEPS
    oracle = [k for k in summary["kernel_dispatch"] if k.startswith("torch_oracle")]
    if launches != expect or oracle or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}; dispatch "
                             f"{summary['kernel_dispatch']}")
    wb = summary["weight_bytes"]
    if not (summary["logits_finite"] and wb["compressed"] < wb["dense"]):
        raise AssertionError(f"{cell}: non-finite logits or packed bytes not below "
                             f"dense: {summary['logits_finite']}, {wb}")
    log({"phase": "recurrent", "cell": cell, "arch": arch, "layers": cfg.n_layers,
         "depth_cut": f"{full.n_layers} -> {layers}" if layers else None,
         "pack_s": pack_s, "launches": launches,
         "launches_want": f"{per_step} a step x {RECURRENT_DECODE_STEPS} steps",
         "kernel_dispatch": summary["kernel_dispatch"],
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "sample": summary["sample"], "weight_bytes": wb})
    n_packed = sum(len(ws) for ws in _recurrent_packed(params).values())
    row = check_vs_dense(cell, model, params, tokens, kernel, 1, want_packed=n_packed,
                         prefill=lambda p: serve.prefill_cache(model, p, tokens,
                                                               tokens.shape[1])[:2])
    return {"launches": launches[kernel], "decompress_launches": row["decompress_launches"],
            "model": model, "params": params, "tokens": tokens, "logits": row["logits"]}


def phase_recurrent_chunked(cell: str, sl: dict) -> None:
    """``LM.apply`` (the chunked SSD form, which static serving never runs)
    against the stepped decode path at the last prompt position, on the
    cell's packed weights: within LOGIT_TOL of the stepped logits' largest
    magnitude (both round to bf16, in other places of the sums)."""
    model, params, tokens = sl["model"], sl["params"], sl["tokens"]
    with torch.inference_mode():
        chunked = model.prefill(params, tokens)[0]
    chunked = chunked[:, :model.cfg.vocab].float()
    stepped = sl["logits"]                   # check_vs_dense's kernel-path prefill
    err = (chunked - stepped).abs().max().item()
    scale = stepped.abs().max().item()
    agree = (chunked.argmax(-1) == stepped.argmax(-1)).float().mean().item()
    log({"phase": "recurrent_chunked_vs_stepped", "cell": cell, "max_abs_err": err,
         "max_abs_logit": scale, "tol": LOGIT_TOL * scale, "argmax_agreement": agree})
    if not err <= LOGIT_TOL * scale:
        raise AssertionError(f"{cell}: the chunked forward's last logits differ from the "
                             f"stepped decode's: {err} > {LOGIT_TOL * scale}")


def phase_recurrent_engine(run: str, cells: dict) -> dict:
    """One engine run (the slot regime, fused admission: each prompt
    replayed through the batch-1 decode step) through ``serve.main
    --engine`` on a cell's packed weights over phase 6's trace (4 slots),
    every request held against ``static_generate`` bit for bit; the cell's
    kernel launched and the others not, no ``torch_oracle`` dispatch."""
    cell = RECURRENT_ENGINE_RUNS[run]
    arch, *_, kernel = RECURRENT_CELLS[cell]
    sl = cells[cell]
    model, params = sl["model"], sl["params"]
    reset_counts()
    summary = serve.main(["--arch", arch] + ENGINE_ARGV[2:],
                         prepared=(model, params, sl["tokens"]))
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    trace, tokens = summary["trace"], summary["tokens"]
    other = "block_matmul" if kernel == "sod_matmul" else "sod_matmul"
    oracle = [k for k in summary["kernel_dispatch"] if k.startswith("torch_oracle")]
    if not (launches[kernel] > 0 and launches[other] == 0 and launches["decompress"] == 0
            and not oracle and summary["logits_finite"]
            and summary["page_size"] is None):
        raise AssertionError(f"engine {run}: launches {launches}, dispatch "
                             f"{summary['kernel_dispatch']}, finite "
                             f"{summary['logits_finite']}, page size {summary['page_size']}")
    if summary["completed"] != len(trace) or set(tokens) != {r.rid for r in trace}:
        raise AssertionError(f"engine {run}: {summary['completed']} of "
                             f"{len(trace)} requests completed")
    static_s = _check_tokens(run, model, params, trace, tokens)
    row = {"phase": "recurrent_engine", "run": run, "cell": cell,
           "launches": launches[kernel], "kernel_dispatch": summary["kernel_dispatch"],
           "prompt_lens": [len(r.tokens) for r in trace],
           "bit_equal_to_static_generate": True, "static_generate_s": static_s,
           **{k: summary[k] for k in (
               "completed", "steps", "generated_tokens", "warmup_s", "steady_tok_per_s",
               "p50_latency_s", "p99_latency_s", "ttft_p50_s", "ttft_p99_s",
               "step_ms_p50", "step_ms_p99", "logits_finite")}}
    log(row)
    return row


@contextlib.contextmanager
def _ranges(spots):
    """While open, each ``(module, function name, label)`` of ``spots``
    runs inside ``torch.profiler.record_function(label)``."""
    from torch.profiler import record_function

    saved = [(mod, name, getattr(mod, name), label) for mod, name, label in spots]

    def wrap(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    for mod, name, fn, label in saved:
        setattr(mod, name, wrap(fn, label))
    try:
        yield
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)


def _profile_decode_step(model, params, cache, tok, pos: int, spots) -> tuple:
    """One warm decode step at ``pos``, 7 timed ones after it, then one more
    under ``torch.profiler`` with each ``(module, function name, label)`` of
    ``spots`` inside a labelled range (:func:`_ranges`).  Returns the median
    wall ms of the 7, device µs and calls by kernel name, and the operators'
    self device µs by the range they ran in ("" outside every range) and
    operator name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.decode_step(params, cache, tok, pos)
        step_ms = []
        for t in range(1, 8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(params, cache, tok, pos + t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with _ranges(spots), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, cache, tok, pos + 8)
            torch.cuda.synchronize()
    labels = {label for *_, label in spots}
    per_kernel: dict[str, tuple[float, int]] = {}
    by_range: dict[str, dict[str, float]] = {}
    for ev in prof.events():
        if ev.name in labels:         # a labelled range's span, not an operator
            continue
        if ev.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
            continue
        self_us = getattr(ev, "self_device_time_total", 0.0)
        if not self_us:
            continue
        rng, p = None, getattr(ev, "cpu_parent", None)
        while p is not None and rng is None:
            rng = p.name if p.name in labels else None
            p = p.cpu_parent
        ops = by_range.setdefault(rng or "", {})
        ops[ev.name] = ops.get(ev.name, 0.0) + self_us
    return statistics.median(step_ms), per_kernel, by_range


def _sod_kernels(per_kernel: dict) -> tuple[float, int]:
    """(ms, calls) of the SoD matmul kernels among a step's kernels."""
    sod = [(us, n) for k, (us, n) in per_kernel.items()
           if "sod_matmul" in k or "block_matmul" in k]
    return sum(us for us, _ in sod) / 1e3, sum(n for _, n in sod)


def phase_recurrent_profile(sl: dict) -> None:
    """One steady static decode step of zamba2-2.7b (batch 4, full width, the
    cell's depth) under ``torch.profiler``: device ms by class — the SoD kernels
    (the head's call among them), the Mamba2 blocks' scan and conv (their
    operators but the dense GEMMs of w_b, w_c, w_dt, which are apart), the
    shared block's attention core, and the rest — the head alone timed as
    phase 9 times it, and the idle share against the median wall of 7
    unprofiled steps.  Operators are classed by the labelled range they
    run in (``record_function`` around ``ssm.mamba_decode_step`` and
    ``attention._attend_cached``)."""
    from repro_torch.models import attention, ssm

    model, params, tokens = sl["model"], sl["params"], sl["tokens"]
    cfg = model.cfg
    spots = [(ssm, "mamba_decode_step", "mamba"),
             (attention, "_attend_cached", "attention_core")]
    with torch.inference_mode():
        _, cache, pos = serve.prefill_cache(model, params, tokens, 48)
    tok = torch.zeros((tokens.shape[0], 1), dtype=torch.long, device="cuda")
    step, per_kernel, by_range = _profile_decode_step(model, params, cache, tok, pos, spots)
    with torch.inference_mode():
        h = torch.randn(tokens.shape[0], 1, cfg.d_model, device="cuda").bfloat16()
        head_ms = _time_ms(lambda: transformer._head(params, h, cfg), timing.flush_buffer())
    mamba = by_range.get("mamba", {})
    classes = {"mamba_scan_conv": sum(us for op, us in mamba.items()
                                      if not op.startswith("aten::mm")),
               "mamba_dense_gemm": sum(us for op, us in mamba.items()
                                       if op.startswith("aten::mm")),
               "attention_core": sum(by_range.get("attention_core", {}).values()),
               "other_ops": sum(by_range.get("", {}).values())}
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    sod_ms, sod_calls = _sod_kernels(per_kernel)
    measured = bool(rows)
    log({"phase": "recurrent_profile", "cell": "zamba2_tiled_csc", "arch": cfg.name,
         "what": f"one static decode step, batch 4, full width, {cfg.n_layers} layers, "
                 "bf16",
         "step_ms_median_of_7": step,
         "device_ms": total_ms if measured else "not measured",
         "device_idle_share": (1 - total_ms / step) if measured else "not measured",
         "sod_kernels_ms": sod_ms if measured else "not measured",
         "sod_kernel_calls": sod_calls, "head_alone_ms": head_ms,
         **{f"{k}_ms": (v / 1e3 if any(classes.values()) else "not measured")
            for k, v in classes.items()},
         "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:15]]})


def phase_recurrent_train(run: str) -> dict:
    """``train_xlstm`` / ``train_zamba2``: full width (xlstm at 4 layers,
    zamba2 at 6),
    tiled_csc 0.3, batch 8 × seq 128, remat on (every layer group checkpointed),
    RECURRENT_TRAIN_STEPS steps, gated on finite losses and gradient norms,
    integer leaves bit-equal to the initial pack, only ``cuda_fused``
    dispatched, and the launches a step: the groups' packed projections
    twice (remat) and the head once of ``sod_matmul``, and every forward
    call once of ``decompress`` (each backward re-densifies its weight; the
    hybrid's shared block once an application); then one steady step is
    profiled."""
    arch, layers = RECURRENT_TRAIN_RUNS[run]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
    argv = (["--arch", arch] + FAMILY_TRAIN_ARGV[2:]
            + ["--steps", str(RECURRENT_TRAIN_STEPS), "--ckpt-dir", tmp])
    try:
        t0 = time.perf_counter()
        prep = train.prepare(train.parse_args(argv), configs.get_config(arch).with_(
            n_layers=layers) if layers else None)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        ints = {k: v.clone() for k, v in leaves_with_path(prep[1])
                if not v.is_floating_point()}
        cfg = prep[0].cfg
        per_step = _recurrent_per_step(cfg)
        counted = _runs_a_step(prep[1], cfg)
        reset_counts()
        summary = train.main(argv, prepared=prep)
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        del prep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    params = summary["state"]["params"]
    losses, gnorms = summary["losses"], summary["grad_norms"]
    remat = 2 if cfg.remat else 1
    want = {"sod_matmul": (remat * (per_step - 1) + 1) * RECURRENT_TRAIN_STEPS,
            "block_matmul": 0, "decompress": per_step * RECURRENT_TRAIN_STEPS}
    final_ints = {k: v for k, v in leaves_with_path(params) if not v.is_floating_point()}
    gates = {
        "packed_a_step": counted == per_step,
        "finite": all(map(math.isfinite, losses + gnorms)),
        "integer_leaves_bit_equal": final_ints.keys() == ints.keys() and all(
            torch.equal(v, ints[k]) for k, v in final_ints.items()),
        "dispatch_only_cuda_fused": bool(summary["kernel_dispatch"]) and all(
            k.startswith("cuda_fused[") for k in summary["kernel_dispatch"]),
        "launches": launches == want and summary["kernel_launches"] == want,
    }
    row = {"phase": "recurrent_train", "run": run, "arch": arch, "layers": cfg.n_layers,
           "steps": RECURRENT_TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "prepare_s": prepare_s, "losses": losses, "grad_norms": gnorms,
           "launches": launches, "launches_want": want,
           "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
           "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"{run}: a gate failed: {gates}")
    phase_train_profile(summary, run, argv, layers)
    return {"launches": launches}


def phase_recurrent(timed) -> dict:
    """Phase 11: the kernels at the recurrent families' shapes, each cell
    with its engine run (zamba2's chunked forward held against its stepped
    decode and one decode step profiled), each freed before the next, then
    ``train_xlstm`` and ``train_zamba2``; every step through ``timed``."""
    out = {"kernels": timed("recurrent:kernels", phase_family_kernels, RECURRENT_SHAPES,
                            RECURRENT_QMODES, 7000, "recurrent_kernels"),
           "launches": {}, "engine": {}, "train": {}}
    cells = {}
    for cell in RECURRENT_CELLS:
        sl = cells[cell] = timed(f"recurrent:{cell}", phase_recurrent_serve, cell)
        out["launches"][cell] = {k: sl[k] for k in ("launches", "decompress_launches")}
        if cell == "zamba2_tiled_csc":
            timed("recurrent:chunked", phase_recurrent_chunked, cell, sl)
            timed("recurrent:profile", phase_recurrent_profile, sl)
        for run, of in RECURRENT_ENGINE_RUNS.items():
            if of == cell:
                out["engine"][run] = timed(f"recurrent:engine:{run}",
                                           phase_recurrent_engine, run, cells)
        for key in ("model", "params", "tokens", "logits"):
            sl.pop(key)
        torch.cuda.empty_cache()
    for run in RECURRENT_TRAIN_RUNS:
        out["train"][run] = timed(f"recurrent:{run}", phase_recurrent_train, run)
        torch.cuda.empty_cache()
    return out


def _recurrent_entry(name: str, qmode: str, rec: dict) -> dict:
    """Phase 11's numbers of one kernel in one qmode: its launches in each
    recurrent cell, engine run and training run (counted from 0 around each
    run), and its rows at the recurrent shapes."""
    out = {}
    if qmode == "none":
        launches = {}
        for cell, (*_, kernel) in RECURRENT_CELLS.items():
            if name == kernel:
                launches[cell] = rec["launches"][cell]["launches"]
            elif name == "decompress" and kernel == "sod_matmul":
                launches[f"{cell}:densified"] = rec["launches"][cell]["decompress_launches"]
        launches.update({f"engine:{run}": row["launches"] for run, row in
                         rec["engine"].items() if RECURRENT_CELLS[row["cell"]][4] == name})
        if name != "block_matmul":
            launches.update({run: r["launches"][name] for run, r in rec["train"].items()})
        out["recurrent_launches"] = launches
    rows = [r for (kn, q, *_), r in rec["kernels"].items() if kn == name and q == qmode]
    if rows:
        out["recurrent_shapes"] = [
            {k: r[k] for k in ("shape", "K", "N", "M", "out_dtype", "max_abs_err",
                               "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")} for r in rows]
    return out


# ---------------------------------------------------------------------------
# phase 12: the VLM and audio frontends
# ---------------------------------------------------------------------------
# (K, N) -> (what, the output dtype on the model's path: f32 for a head)
FRONTEND_SHAPES = {
    "sod_matmul": {(5120, 14336): ("pixtral w_gate+w_up", torch.bfloat16),
                   (14336, 5120): ("pixtral w_down", torch.bfloat16),
                   (5120, 131072): ("pixtral head", torch.float32),
                   (1536, 8192): ("musicgen head (4 codebooks)", torch.float32)},
    "block_matmul": {(5120, 14336): ("pixtral w_gate+w_up", torch.bfloat16),
                     (14336, 5120): ("pixtral w_down", torch.bfloat16),
                     (5120, 131072): ("pixtral head", torch.float32),
                     (1536, 8192): ("musicgen head (4 codebooks)", torch.float32)},
    "decompress": {(5120, 14336): ("pixtral w_gate+w_up", None),
                   (14336, 5120): ("pixtral w_down", None),
                   (1536, 8192): ("musicgen head (4 codebooks)", None)},
}
FRONTEND_QMODES = {"sod_matmul": ("none", "int8"), "block_matmul": ("none",),
                   "decompress": ("none",)}
FRONTEND_GEN = 16
# cell -> (arch, layers, flags, caller's SoDConfig, kernel); full width,
# pixtral at 8 of its 40 layers and musicgen at 12 of its 48, for the
# script's time (a 948 s run on an H100 spent 130 s in this phase at full
# depth).  pixtral: batch 2 of 1024 patches + 512 text tokens (a VLM prompt
# is n_patches + 512·k at attn_chunk 512), 3072 prefill rows
FRONTEND_CELLS = {
    "pixtral_tiled_csc": ("pixtral-12b", 8, ["--batch", "2", "--prompt-len", "1536"],
                          None, "sod_matmul"),
    "musicgen_tiled_csc": ("musicgen-medium", 12, ["--batch", "4", "--prompt-len", "32"],
                           None, "sod_matmul"),
    "musicgen_block_csr": ("musicgen-medium", 12, ["--batch", "4", "--prompt-len", "32"],
                           _block_sod(), "block_matmul"),
}
# run -> (arch, layers (None: full depth), batch, seq); pixtral at 2 layers:
# AdamW's float32 state of ≈ 12 B parameters does not fit beside them;
# musicgen at 8 of its 48 layers, for the script's time (67 s at 48 and
# 29 s at 24 on an H100)
FRONTEND_TRAIN_RUNS = {"train_musicgen": ("musicgen-medium", 8, TRAIN_BATCH, TRAIN_SEQ),
                       "train_pixtral": ("pixtral-12b", 2, 1, 1536)}
FRONTEND_TRAIN_STEPS = 4


def phase_frontend_serve(cell: str) -> dict:
    """One FRONTEND_CELLS cell at full width and its depth cut: its weights prepared
    (``patch_proj`` and the embeddings dense, the head packed), served
    through ``serve.main`` with every launch count read around the run ((layers
    · 7 + the head) × 17 of its kernel, none of the others, no
    ``torch_oracle`` dispatch; musicgen's decoded ids (B, 16, 4), each
    below its vocabulary), then the last prompt position's logits held
    against the densified weights' (the head included), both prefills
    timed."""
    arch, layers, flags, sod, kernel = FRONTEND_CELLS[cell]
    argv = ["--arch", arch, *flags, "--gen", str(FRONTEND_GEN), "--seed", "0",
            "--device", "cuda"] + ([] if sod else FAMILY_TILED)
    args = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prep = serve.prepare(args, sod, configs.get_config(arch).with_(n_layers=layers))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    model, params, tokens, patches = prep.model, prep.params, prep.tokens, prep.patch_embeds
    cfg = model.cfg
    leaves = {k: type(params[k]).__name__ for k in ("embed", "patch_proj", "head")
              if k in params}
    if not (leaves["head"] in ("TiledCSC", "BlockCSR")
            and all(leaves[k] == "Tensor" for k in leaves if k != "head")
            and (patches is not None) == (cfg.family == "vlm")):
        raise AssertionError(f"{cell}: frontend leaves {leaves}, patches "
                             f"{patches is not None}")
    reset_counts()
    summary = serve.main(argv, sod=sod, prepared=prep)
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    expect = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    expect[kernel] = (cfg.n_layers * 7 + 1) * (1 + FRONTEND_GEN)
    oracle = [k for k in summary["kernel_dispatch"] if k.startswith("torch_oracle")]
    if launches != expect or oracle or summary["kernel_launches"] != {
            k: v for k, v in expect.items() if k != "decompress"}:
        raise AssertionError(f"{cell}: launches {launches} (summary "
                             f"{summary['kernel_launches']}), want {expect}; dispatch "
                             f"{summary['kernel_dispatch']}")
    ids = torch.tensor(summary["generated_ids"])
    want_ids = (args.batch, FRONTEND_GEN) + ((cfg.n_codebooks,) if cfg.family == "audio"
                                             else ())
    wb = summary["weight_bytes"]
    if not (summary["logits_finite"] and wb["compressed"] < wb["dense"]
            and tuple(ids.shape) == want_ids and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab):
        raise AssertionError(f"{cell}: finite {summary['logits_finite']}, bytes {wb}, "
                             f"ids {tuple(ids.shape)} (want {want_ids}) in "
                             f"[{int(ids.min())}, {int(ids.max())}]")
    log({"phase": "frontend", "cell": cell, "arch": arch, "layers": cfg.n_layers,
         "batch": args.batch, "prompt_len": args.prompt_len,
         "n_patches": cfg.n_patches if cfg.family == "vlm" else None,
         "pack_s": pack_s, "launches": launches,
         "launches_want": f"({cfg.n_layers} * 7 + 1) * {1 + FRONTEND_GEN}",
         "kernel_dispatch": summary["kernel_dispatch"],
         "prefill_s": summary["prefill_s"], "warmup_s": summary["warmup_s"],
         "steady_tok_per_s": summary["steady_tok_per_s"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "generated_ids_shape": list(ids.shape), "sample": summary["sample"],
         "weight_bytes": wb})
    row = check_vs_dense(cell, model, params, tokens, kernel, cfg.n_layers,
                         prefill=lambda p: model.prefill(p, tokens, patch_embeds=patches))
    return {"launches": launches[kernel], "decompress_launches": row["decompress_launches"],
            "prefill_s": summary["prefill_s"], "kernel_prefill_s": row["kernel_prefill_s"],
            "dense_prefill_s": row["dense_prefill_s"], "model": model, "params": params,
            "tokens": tokens, "patch_embeds": patches}


def phase_frontend_decode(sl: dict) -> dict:
    """pixtral's decode step at the position its cache gives the next
    token, ``n_patches`` + the text's length (static serving decodes at the
    text's length: fault R5, the reference's), against the full forward
    over the prompt and that token (``LM.apply`` with one attention chunk
    over all 1537 positions: 1537 divides into no 512-chunks), on the cell's
    packed weights: within LOGIT_TOL of the forward's largest logit.  The
    decode at R5's position is logged beside it."""
    model, params, tokens, patches = (sl[k] for k in ("model", "params", "tokens",
                                                       "patch_embeds"))
    cfg = model.cfg
    with torch.inference_mode():
        last, cache = model.prefill(params, tokens, patch_embeds=patches)
        s = cfg.n_patches + tokens.shape[1]
        cache = model.grow_cache(cache, s + 1)
        r5 = {k: v.clone() for k, v in cache.items()}
        nxt = last.argmax(dim=-1).reshape(-1, 1)
        step, _ = model.decode_step(params, cache, nxt, s)
        wrong, _ = model.decode_step(params, r5, nxt, tokens.shape[1])
        del r5, cache
        full = LM(cfg.with_(attn_chunk=s + 1)).apply(
            params, torch.cat([tokens, nxt], 1), patch_embeds=patches)[0][:, -1]
    vocab = cfg.vocab
    step, wrong, full = (t[:, 0, :vocab].float() if t.dim() == 3 else t[:, :vocab].float()
                         for t in (step, wrong, full))
    err = (step - full).abs().max().item()
    scale = full.abs().max().item()
    row = {"phase": "frontend_decode", "cell": "pixtral_tiled_csc", "position": s,
           "max_abs_err": err, "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
           "argmax_agreement": (step.argmax(-1) == full.argmax(-1)).float().mean().item(),
           "r5_position": tokens.shape[1],
           "r5_max_abs_err": (wrong - full).abs().max().item()}
    log(row)
    if not (torch.isfinite(step).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"pixtral: the decode step at {s} differs from the forward: "
                             f"{err} > {LOGIT_TOL * scale}")
    return row


def phase_frontend_profile(cell: str, sl: dict) -> dict:
    """One steady static decode step of the cell (full width at its depth, its
    batch, the cache at the prompt's length; the step's cost does not depend
    on the cache's values, so it starts from a zeroed one) under
    ``torch.profiler``: device ms by class — the SoD kernels (the head's
    among them), attention (``attention._attend_cached``, labelled), the
    rest — the head alone timed as phase 9 times it, and the idle share
    against the median wall of 7 unprofiled steps."""
    from repro_torch.models import attention

    model, params, tokens = sl["model"], sl["params"], sl["tokens"]
    cfg = model.cfg
    b = tokens.shape[0]
    pos = tokens.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    tok = torch.zeros((b, 1) + ((cfg.n_codebooks,) if cfg.family == "audio" else ()),
                      dtype=torch.long, device="cuda")
    cache = model.init_cache(b, pos + 16, "cuda")
    step, per_kernel, by_range = _profile_decode_step(
        model, params, cache, tok, pos,
        [(attention, "_attend_cached", "attention_core")])
    with torch.inference_mode():
        h = torch.randn(b, 1, cfg.d_model, device="cuda").bfloat16()
        head_ms = _time_ms(lambda: transformer._head(params, h, cfg), timing.flush_buffer())
    rows = sorted(((us, k, n) for k, (us, n) in per_kernel.items()), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    sod_ms, sod_calls = _sod_kernels(per_kernel)
    attention_ms = sum(by_range.get("attention_core", {}).values()) / 1e3
    measured = bool(rows)
    row = {"phase": "frontend_profile", "cell": cell, "arch": cfg.name,
           "what": f"one static decode step, batch {b}, full width, {cfg.n_layers} "
                   f"layers, bf16, at position {pos}",
           "step_ms_median_of_7": step,
           "device_ms": total_ms if measured else "not measured",
           "device_idle_share": (1 - total_ms / step) if measured else "not measured",
           "sod_kernels_ms": sod_ms if measured else "not measured",
           "sod_kernel_calls": sod_calls, "head_alone_ms": head_ms,
           "attention_ms": attention_ms if measured else "not measured",
           "rest_ms": (total_ms - sod_ms - attention_ms) if measured else "not measured",
           "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:12]]}
    log(row)
    return row


def phase_frontend_train(run: str) -> dict:
    """``train_musicgen`` (full width, 8 layers, batch 8 × seq 128) and
    ``train_pixtral`` (full width, 2 layers, batch 1 × seq 1536: 1024
    patches and 512 text tokens, the loss on the text), tiled_csc 0.3,
    remat on, FRONTEND_TRAIN_STEPS steps.  First one gradient of the loss:
    ``patch_proj``'s (pixtral) or the embedding stack's (musicgen) finite
    and not all 0.  Then ``train.main``, gated on finite losses and
    gradient norms, integer leaves bit-equal to the initial pack, only
    ``cuda_fused`` dispatched, and the launches a step: every layer's 7
    projections twice (remat) and the head once of ``sod_matmul``, each
    once and the head of ``decompress``; one steady step profiled."""
    arch, layers, batch, seq = FRONTEND_TRAIN_RUNS[run]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
    argv = (["--arch", arch, "--batch", str(batch), "--seq", str(seq)]
            + FAMILY_TRAIN_ARGV[6:]
            + ["--steps", str(FRONTEND_TRAIN_STEPS), "--ckpt-dir", tmp])
    try:
        args = train.parse_args(argv)
        t0 = time.perf_counter()
        full = configs.get_config(arch)
        prep = train.prepare(args, full.with_(n_layers=layers) if layers else None)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        model, params, plan = prep
        cfg = model.cfg
        frontend = "patch_proj" if cfg.family == "vlm" else "embed"
        data = SyntheticLMData(cfg, batch, seq, seed=args.seed)
        _, _, grads = steps_mod.make_loss_and_grads(model, plan=plan)(
            params, to_device(data.batch(0), "cuda"))
        g = grads[frontend]
        grad_row = {"leaf": frontend, "shape": list(g.shape),
                    "max_abs": g.float().abs().max().item(),
                    "finite": bool(torch.isfinite(g).all())}
        del grads, g
        ints = {k: v.clone() for k, v in leaves_with_path(params)
                if not v.is_floating_point()}
        reset_counts()
        summary = train.main(argv, prepared=prep)
        launches = {name: mod.launches for name, mod in COUNTERS.items()}
        del prep, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    final = summary["state"]["params"]
    losses, gnorms = summary["losses"], summary["grad_norms"]
    remat = 2 if cfg.remat else 1
    per_fwd = cfg.n_layers * 7
    want = {"sod_matmul": (remat * per_fwd + 1) * FRONTEND_TRAIN_STEPS,
            "block_matmul": 0, "decompress": (per_fwd + 1) * FRONTEND_TRAIN_STEPS}
    final_ints = {k: v for k, v in leaves_with_path(final) if not v.is_floating_point()}
    gates = {
        "frontend_grad_nonzero_and_finite": grad_row["finite"] and grad_row["max_abs"] > 0,
        "finite": all(map(math.isfinite, losses + gnorms)),
        "integer_leaves_bit_equal": final_ints.keys() == ints.keys() and all(
            torch.equal(v, ints[k]) for k, v in final_ints.items()),
        "head_packed": isinstance(final["head"], TiledCSC),
        "dispatch_only_cuda_fused": bool(summary["kernel_dispatch"]) and all(
            k.startswith("cuda_fused[") for k in summary["kernel_dispatch"]),
        "launches": launches == want and summary["kernel_launches"] == want,
    }
    row = {"phase": "frontend_train", "run": run, "arch": arch, "layers": cfg.n_layers,
           "steps": FRONTEND_TRAIN_STEPS, "batch": batch, "seq": seq,
           "prepare_s": prepare_s, "frontend_grad": grad_row, "losses": losses,
           "grad_norms": gnorms, "launches": launches, "launches_want": want,
           "kernel_dispatch": summary["kernel_dispatch"],
           **{k: summary[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
           "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"{run}: a gate failed: {gates}")
    phase_train_profile(summary, run, argv, layers)
    return {"launches": launches, "step_s": summary["step_s"],
            "peak_mem_gb": summary["peak_mem_gb"]}


def phase_frontends(timed) -> dict:
    """Phase 12: the kernels at the frontend families' shapes, each cell
    (pixtral's decode at its true position and one decode step of pixtral
    and of musicgen_tiled_csc profiled), each freed before the next, then
    ``train_musicgen`` and ``train_pixtral``; every step through
    ``timed``."""
    out = {"kernels": timed("frontends:kernels", phase_family_kernels, FRONTEND_SHAPES,
                            FRONTEND_QMODES, 9000, "frontend_kernels"),
           "launches": {}, "train": {}}
    for cell in FRONTEND_CELLS:
        sl = timed(f"frontends:{cell}", phase_frontend_serve, cell)
        out["launches"][cell] = {k: sl[k] for k in ("launches", "decompress_launches")}
        if cell == "pixtral_tiled_csc":
            timed("frontends:decode", phase_frontend_decode, sl)
        if cell != "musicgen_block_csr":
            timed("frontends:profile", phase_frontend_profile, cell, sl)
        for key in ("model", "params", "tokens", "patch_embeds"):
            sl.pop(key)
        torch.cuda.empty_cache()
    for run in FRONTEND_TRAIN_RUNS:
        out["train"][run] = timed(f"frontends:{run}", phase_frontend_train, run)
        torch.cuda.empty_cache()
    return out


def _frontend_entry(name: str, qmode: str, fe: dict) -> dict:
    """Phase 12's numbers of one kernel in one qmode: its launches in each
    frontend cell and training run (counted from 0 around each run), and
    its rows at the frontend shapes."""
    out = {}
    if qmode == "none":
        launches = {}
        for cell, (*_, kernel) in FRONTEND_CELLS.items():
            if name == kernel:
                launches[cell] = fe["launches"][cell]["launches"]
            elif name == "decompress" and kernel == "sod_matmul":
                launches[f"{cell}:densified"] = fe["launches"][cell]["decompress_launches"]
        if name != "block_matmul":
            launches.update({run: r["launches"][name] for run, r in fe["train"].items()})
        out["frontend_launches"] = launches
    rows = [r for (kn, q, *_), r in fe["kernels"].items() if kn == name and q == qmode]
    if rows:
        out["frontend_shapes"] = [
            {k: r[k] for k in ("shape", "K", "N", "M", "out_dtype", "max_abs_err",
                               "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")} for r in rows]
    return out


# ---------------------------------------------------------------------------
# phase 13: the paper-claims layer's examples, run in-process on the card
# ---------------------------------------------------------------------------
# the example's --full run (xlstm-125m at full depth, batch 8 × seq 512) at
# 2 steps, for the script's time (6.2 s a step on an H100)
PAPER_TRAIN_STEPS = 2


def _script(path: pathlib.Path):
    """A script of the checkout (an example, the probe) as a module."""
    spec = importlib.util.spec_from_file_location(f"_chip_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _twin(name: str):
    """One of the reference examples' twins, ``examples/<name>.py``."""
    return _script(ROOT / "examples" / f"{name}.py")


def _attention_per_forward(cfg) -> int:
    """Packed projections one forward of the dense family runs, from the
    config: 7 a layer (wq, wk, wv, wo, w_gate, w_up, w_down; at the reduced
    size every one is at least min_dim = 64 wide) and an untied head."""
    return cfg.n_layers * 7 + (0 if cfg.tie_embeddings else 1)


def _packed_leaves(params) -> int:
    """Packed operands in a tree: each runs once a forward."""
    return sum(isinstance(leaf, (TiledCSC, BlockCSR))
               for leaf in sod_mod._all_leaves(params))


def _no_oracle(what: str, dispatch: dict) -> None:
    oracle = [k for k in dispatch if k.startswith("torch_oracle")]
    if oracle:
        raise AssertionError(f"{what}: the plain version dispatched on the card: "
                             f"{dispatch}")


def phase_paper_quickstart() -> dict:
    """``torch_quickstart``: the 1024 × 1024 pack's bytes and ratio, the
    forced ``sod_matmul`` at M = 256 against ``x @ w_sparse`` (max |err| <
    1e-3, float32), and one batch's loss of the reduced llama3.2-1b packed
    with min_dim 64: 1 + 2 · 7 launches, no other kernel, no ``torch_oracle``."""
    qs = _twin("torch_quickstart")
    reset_counts()
    out = qs.main(["--device", "cuda"])
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    cfg = configs.reduced(configs.get_config("llama3.2-1b"))
    want = {"sod_matmul": 1 + _attention_per_forward(cfg), "block_matmul": 0,
            "decompress": 0}
    _no_oracle("quickstart", out["kernel_dispatch"])
    gates = {"launches": launches == want
             and out["kernel_launches"] == want["sod_matmul"],
             "max_abs_err": out["max_abs_err"] < qs.TOL,
             "loss_finite": math.isfinite(out["loss"]),
             "packed_below_dense": out["compressed_bytes"] < out["dense_bytes"]}
    row = {"phase": "paper", "twin": "torch_quickstart", "launches": launches,
           "launches_want": want, **{k: out[k] for k in (
               "density", "dense_bytes", "compressed_bytes", "compression_ratio",
               "max_abs_err", "loss", "model_bytes", "kernel_dispatch")},
           "gates": gates}
    log(row)
    if not all(gates.values()):
        raise AssertionError(f"quickstart: a gate failed: {gates}")
    return {"launches": launches}


def phase_paper_serve() -> dict:
    """``torch_serve_decode``'s four runs: each run's launches derived from
    its config (dense and zamba2 unpacked: none; llama tiled_csc: 2 · 7 a
    forward × 17 forwards; the engine under its plan: the packed operands of
    its weights × its step calls), finite logits, no ``torch_oracle``, and
    every engine request equal to ``static_generate`` under the plan on the
    card, bit for bit."""
    sd = _twin("torch_serve_decode")
    reset_counts()
    # no target weights exist before the run: every step's launches count as
    # the "draft" tier's
    with _engine_probe(None) as seen:
        out = sd.main(["--device", "cuda"])
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    (eng,) = seen["engines"]
    runs = {}
    for run, summary in out.items():
        _no_oracle(f"serve_decode {run}", summary["kernel_dispatch"])
        argv = sd.RUNS[run][1]
        cfg = configs.reduced(configs.get_config(argv[argv.index("--arch") + 1]))
        if run == "engine":
            per_forward, forwards = _packed_leaves(eng.params), seen["calls"]
        elif "--sod" in argv:
            per_forward, forwards = _attention_per_forward(cfg), 1 + int(
                argv[argv.index("--gen") + 1])
        else:
            per_forward, forwards = 0, 0
        runs[run] = {"launches": summary["kernel_launches"],
                     "want": {"sod_matmul": per_forward * forwards, "block_matmul": 0},
                     "per_forward": per_forward, "forwards": forwards,
                     "logits_finite": summary["logits_finite"]}
    static_s = _engine_gate("serve_decode engine", out["engine"], eng.model, eng.params,
                            eng.plan)
    total = sum(r["launches"]["sod_matmul"] for r in runs.values())
    gates = {"launches": all(r["launches"] == r["want"] for r in runs.values())
             and launches == {"sod_matmul": total, "block_matmul": 0, "decompress": 0},
             # every launch of the run was in the engine's step calls
             "engine_per_forward": runs["engine"]["per_forward"] > 0
             and seen["draft"] == runs["engine"]["launches"]["sod_matmul"],
             "logits_finite": all(r["logits_finite"] for r in runs.values()),
             "engine_bit_equal_to_static_generate": True}
    log({"phase": "paper", "twin": "torch_serve_decode", "runs": runs,
         "launches": launches, "engine_steps": out["engine"]["steps"],
         "static_generate_s": static_s, "gates": gates})
    if not all(gates.values()):
        raise AssertionError(f"serve_decode: a gate failed: {gates}")
    return {"launches": launches}


def phase_paper_train() -> dict:
    """``torch_train_sparse_lm --full --steps 2``: xlstm-125m at full width,
    batch 8 × seq 512, tiled_csc 0.4: finite losses and gradient norms, only
    ``cuda_fused`` dispatched, and the launches a step phase 11 derives (the
    packed projections twice under remat and the head once of
    ``sod_matmul``, every packed call once of ``decompress``); prints the
    seconds a step and the peak memory."""
    tl = _twin("torch_train_sparse_lm")
    cfg = configs.get_config("xlstm-125m")
    per_step = _recurrent_per_step(cfg)
    remat = 2 if cfg.remat else 1
    want = {"sod_matmul": (remat * (per_step - 1) + 1) * PAPER_TRAIN_STEPS,
            "block_matmul": 0, "decompress": per_step * PAPER_TRAIN_STEPS}
    reset_counts()
    out = tl.main(["--full", "--steps", str(PAPER_TRAIN_STEPS), "--device", "cuda"])
    launches = {name: mod.launches for name, mod in COUNTERS.items()}
    losses, gnorms = out["losses"], out["grad_norms"]
    gates = {"full_width": out["arch"] == cfg.name and out["steps"] == PAPER_TRAIN_STEPS,
             "finite": all(map(math.isfinite, losses + gnorms)),
             "dispatch_only_cuda_fused": bool(out["kernel_dispatch"]) and all(
                 k.startswith("cuda_fused[") for k in out["kernel_dispatch"]),
             "launches": launches == want and out["kernel_launches"] == want}
    log({"phase": "paper", "twin": "torch_train_sparse_lm", "arch": out["arch"],
         "batch": 8, "seq": 512, "steps": out["steps"], "losses": losses,
         "grad_norms": gnorms, "launches": launches, "launches_want": want,
         "kernel_dispatch": out["kernel_dispatch"],
         **{k: out[k] for k in ("step_s", "tok_s", "peak_mem_gb", "wall_s")},
         "gates": gates})
    if not all(gates.values()):
        raise AssertionError(f"train_sparse_lm: a gate failed: {gates}")
    return {"launches": launches, "step_s": out["step_s"],
            "peak_mem_gb": out["peak_mem_gb"]}


def phase_paper_rates() -> None:
    """``H100_SXM`` beside what the card reports, and the three places that
    bound or rank kernels reading it (this script, the probe, the
    autotuner's prior)."""
    props = torch.cuda.get_device_properties(0)
    probe = _script(ROOT / "scripts" / "sod_matmul_probe.py")
    h = H100_SXM
    gates = {"chip_smoke": HBM_BYTES_PER_S == h.hbm_bandwidth
             and PEAK_OPS_PER_S[torch.bfloat16] == h.peak_bf16_flops,
             "sod_matmul_probe": probe.HBM_BYTES_PER_S == h.hbm_bandwidth
             and probe.PEAK_BF16_OPS_PER_S == h.peak_bf16_flops,
             "autotune": autotune._MEM_BW["cuda"] == h.hbm_bandwidth
             and autotune._PEAK_FLOPS["cuda"] == h.peak_bf16_flops}
    log({"phase": "paper", "rates": dataclasses.asdict(h),
         "device": {"name": props.name, "total_memory": props.total_memory,
                    "sm_count": props.multi_processor_count,
                    "shared_memory_per_sm": getattr(
                        props, "shared_memory_per_multiprocessor", None)},
         "gates": gates})
    if not all(gates.values()):
        raise AssertionError(f"rates: a gate failed: {gates}")


def phase_paper(timed) -> dict:
    """Phase 13: the three twins in-process on the card, then the rates."""
    out = {"quickstart": timed("paper:quickstart", phase_paper_quickstart),
           "serve_decode": timed("paper:serve_decode", phase_paper_serve),
           "train_sparse_lm": timed("paper:train_sparse_lm", phase_paper_train)}
    torch.cuda.empty_cache()
    timed("paper:rates", phase_paper_rates)
    return out


def _paper_entry(name: str, qmode: str, paper: dict) -> dict:
    """Phase 13's launches of one kernel (qmode none only), by twin."""
    if qmode != "none":
        return {}
    return {"paper_launches": {twin: row["launches"][name]
                               for twin, row in paper.items()}}


# ---------------------------------------------------------------------------
# phase 14: the distributed runtime's execution layer, four ranks on the card
# ---------------------------------------------------------------------------
MESH_SHAPE = (2, 2)                  # (data, model)
MESH_CELLS = {"mesh_tiled_csc": (TILED_ARGV, None, "sod_matmul"),
              "mesh_block_csr": (BASE_ARGV, _block_sod(), "block_matmul")}
# the cell also served with no length given to the decode step, at the
# unrounded length: the cache keeps every position of the rank's KV heads
MESH_WHOLE_SEQ_CELL = "mesh_block_csr"
MESH_PLANS = {"dp": {"batch_axes": ("data",)},
              "col": {"batch_axes": ("data",), "col_axis": "model"},
              "row": {"batch_axes": ("data",), "row_axis": "model"},
              "gather_model": {"batch_axes": ("data",), "gather_axis": "model"},
              "gather_data": {"gather_axis": "data"}}
MESH_GEN = 8
# phase 14's serving cells at 8 of llama's 16 layers, for the script's time
# (35 s at 16 on an H100, in a 1,201 s run)
MESH_SERVE_LAYERS = 8
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 4, 128
# the mesh step's packed gradients against one process's, as a fraction of
# the one-process gradient's largest magnitude: bf16 products whose partial
# sums are added in another order (the column plan's activation gradient
# sums two ranks' halves), through 4 layers; and the loss, relative
MESH_GRAD_TOL, MESH_LOSS_TOL = 0.05, 1e-2
# a recurrent family's leaf is held within MESH_GRAD_TOL of one process's
# bf16 gradient, or within this many times that gradient's own distance
# from its float32 one where that is larger: per-head biases and decays,
# summed over every token with cancellation, are noise in bf16 (on a CPU,
# reduced, one process's bf16 dt_bias and a_log lay 0.075-0.09 from their
# float32 ones); two bf16 evaluations each that far from the float32 one
# lie up to twice it apart, and the mesh's all-reduces round on their own
# (on a CPU, reduced, the mesh read up to 2.2 times it)
MESH_GRAD_FLOOR_X = 3.0
# the elastic step on (1, 2) against one process's on the same checkpoint:
# its loss, relative, and each leaf of the whole state after it, ‖Δ‖ / ‖x‖
# (an H100 read 2.5e-5, and 3.4e-3 parameters, 8.2e-3 m, 9.0e-3 v: bf16
# gradients summed in another order; a step moves the loss 1.2e-3 and a
# restore from another step puts m and v apart by their own size)
ELASTIC_LOSS_TOL, ELASTIC_STATE_TOL = 1e-4, 2e-2
MESH_TIMEOUT_S = 420                 # the rank group's hard limit
# the whole-rows program's numbers, before the steps ran the partitioned
# program (an NVIDIA H100 80GB HBM3 at 700.00 W): mesh_grads' step and a
# rank's peak, and both serving cells' seconds together (the one-process
# runs included); no peak was read for the serving cells
WHOLE_ROWS = {"grads_step_s": 2.144, "grads_peak_mem_gb": 3.616, "serve_s_both_cells": 16.27}


def _backend_flags() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _mesh_ops(layer: dict, kernel: str, mesh) -> dict:
    """One layer's seven projections under each plan kind at M = 4 and 128
    against the single-process kernel's y; the gather plans' received bytes
    against the payload and the napkin fraction."""
    from repro_torch.runtime import spmd, sod_fsdp

    rows, gathered, worst, skipped = [], {}, 0.0, []
    impl = {"sod_matmul": "cuda_fused", "block_matmul": "cuda_block"}[kernel]
    for path in _packed_paths(layer):
        w = _at(layer, path)
        k, n = w.shape
        gen = torch.Generator(device="cuda").manual_seed(k * 7 + n)
        for m in PATH_M.values():
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            y1 = ops.sod_matmul(x, w, spmd=None)
            scale = y1.float().abs().max().item()
            for kind, plan in MESH_PLANS.items():
                plan = spmd.SpmdPlan(**plan)
                try:
                    spmd._validate(plan, mesh, w)
                except ValueError:      # a grid dim the axis does not divide
                    skipped.append((path, kind))
                    continue
                with registry.record_dispatches() as log, \
                        spmd.count_collectives() as counts:
                    y = spmd.sod_matmul_spmd(x, w, mesh=mesh, plan=plan)
                err = (y.float() - y1.float()).abs().max().item()
                worst = max(worst, err / scale)
                if err > KERNEL_TOL[torch.bfloat16] * scale:
                    raise AssertionError(f"mesh {kind} {path} m={m}: |y - y1| {err} > "
                                         f"{KERNEL_TOL[torch.bfloat16]} x {scale}")
                if {r["impl"] for r in log} != {impl} or not all(
                        r["key"].mesh.endswith(plan.signature()) for r in log):
                    raise AssertionError(f"mesh {kind} {path}: dispatched "
                                         f"{[(r['impl'], r['key'].mesh) for r in log]}")
                if plan.gather_axis and m == PATH_M["decode"]:
                    g = mesh.shape[plan.gather_axis]
                    fields = ("vals", "rows") if kernel == "sod_matmul" else (
                        "block_vals", "block_ids", "tile_nnz")
                    payload = sum(_nbytes(getattr(w, f)) for f in fields
                                  if getattr(w, f) is not None)
                    if counts["gather_bytes"] != payload - payload // g:
                        raise AssertionError(f"mesh {kind} {path}: gathered "
                                             f"{counts['gather_bytes']} B, payload {payload}")
                    row = gathered.setdefault(kind, {"received": 0, "payload": 0,
                                                     "dense": 0})
                    row["received"] += counts["gather_bytes"]
                    row["payload"] += payload
                    row["dense"] += 2 * k * n
                rows.append({"path": path, "m": m, "plan": kind, "rel_err": err / scale})
    napkin = sod_fsdp.collective_savings(DENSITY)["weight_allgather_fraction"]
    for row in gathered.values():
        row["payload_fraction_of_dense"] = row["payload"] / row["dense"]
        row["napkin_bytes"] = napkin * row["dense"]
    return {"cases": len(rows), "skipped": len(set(skipped)), "worst_rel_err": worst,
            "gather": gathered, "napkin_fraction": napkin}


def _mesh_serve(model, params, placed, tokens, kernel: str, mesh, *,
                per_forward: int = MESH_SERVE_LAYERS * 7, gen: int = MESH_GEN, plan=None,
                mesh_model=None, pin_routing: bool = False, patch_embeds=None,
                seq_shard: bool = True) -> dict:
    """Prefill (a VLM's with its ``patch_embeds``; a recurrent family's
    prompt stepped through the decode step, ``make_stepped_prefill``) and
    ``gen`` greedy decode steps from the prompt's true end through the
    step builders,
    one process (the whole weights) and the mesh (the resident blocks, fed
    the one-process run's tokens; ``mesh_model``, if given, runs there):
    logits, greedy agreement, launches (``per_forward`` a forward) and the
    mesh run's collectives (a recurrent family's forwards: one a prompt
    position and one a decode step).  With ``pin_routing`` (an MoE model) the mesh
    run routes every token as the one-process run chose (:func:`_routing`:
    a rounding apart can send a token to another expert, which the gate
    would charge to the mesh), and counts the choices its own router would
    have made otherwise (``routing_differs``).  With ``seq_shard`` the
    cache's length is rounded up to a multiple of ``model`` and given to
    the decode step, which splits its sequence over ``model``; without, it
    is what the steps need and the mesh's cache keeps every position of
    the rank's KV heads (:func:`_kv_layout` gates either)."""
    from repro_torch.runtime import spmd

    b, s = tokens.shape[:2]
    start = s + (0 if patch_embeds is None else patch_embeds.shape[1])
    recurrent = model.cfg.family in ("hybrid", "ssm")
    tp = mesh.shape["model"] if seq_shard else 1
    max_len = -(-(start + gen + 1) // tp) * tp
    seq_len = max_len if seq_shard else None
    out, ids, differ = {}, [], []
    with torch.inference_mode():
        logits = {}
        for run, p, m, mdl in (("one", params, None, model),
                               ("mesh", placed, mesh, mesh_model or model)):
            prefill = steps_mod.make_prefill_step(mdl, mesh=m, plan=plan)
            decode = steps_mod.make_decode_step(mdl, mesh=m, plan=plan, seq_len=seq_len)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            reset_counts()
            pin = (contextlib.nullcontext() if not pin_routing else
                   _routing(record=ids) if run == "one" else _routing(replay=ids, differ=differ))
            with registry.count_dispatches() as counts, spmd.count_collectives() as moved, pin:
                if recurrent:         # the prompt stepped through the decode step
                    nxt, cache = steps_mod.make_stepped_prefill(
                        mdl, mesh=m, plan=plan, seq_shard=seq_shard)(p, tokens, max_len)
                else:
                    nxt, cache = prefill(p, tokens, patch_embeds=patch_embeds)
                    cache = mdl.grow_cache(cache, max_len)
                toks, logs = [nxt[:, None]], []
                for t in range(gen):
                    feed = toks[-1] if run == "one" else logits["one_tokens"][t]
                    nxt, lg, cache = decode(p, cache, feed, start + t)
                    toks.append(nxt.reshape(feed.shape))
                    logs.append(lg[..., :model.cfg.vocab].float())
            torch.cuda.synchronize()
            logits[run] = torch.stack(logs)
            logits[f"{run}_tokens"] = toks
            out[run] = {"launches": {k: mod.launches for k, mod in COUNTERS.items()},
                        "dispatch": counts, "collectives": dict(moved),
                        "seconds": time.perf_counter() - t0,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
            if "k" in cache:          # the KV leaf as the rank keeps it
                out[run]["kv_shape"] = list(cache["k"].shape)
    if "kv_shape" in out["mesh"]:
        out["kv_layout"] = _kv_layout((mesh_model or model).cfg, mesh, b, max_len, seq_shard,
                                      out["mesh"]["kv_shape"])
    out["max_len"] = max_len
    ref_logits, mesh_logits = logits["one"], logits["mesh"]
    err = (mesh_logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    agree = torch.stack([(a == b_) for a, b_ in zip(logits["mesh_tokens"][1:],
                                                   logits["one_tokens"][1:])]).float()
    if pin_routing:
        out["routing_differs"] = [sum(d for d, _ in differ), sum(n for _, n in differ)]
    out.update({"max_abs_err": err, "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
                "greedy_agreement": agree.mean().item(),
                "prefill_tokens_equal": bool(torch.equal(logits["mesh_tokens"][0],
                                                         logits["one_tokens"][0]))})
    want = {"sod_matmul": 0, "block_matmul": 0, "decompress": 0}
    want[kernel] = per_forward * ((s if recurrent else 1) + gen)
    if out["mesh"]["launches"] != want:
        raise AssertionError(f"mesh serve launches {out['mesh']['launches']}, want {want}")
    if not (torch.isfinite(mesh_logits).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"mesh logits {err} > {LOGIT_TOL} x {scale}")
    return out


def _kv_layout(cfg, mesh, batch: int, max_len: int, seq_shard: bool, shape: list) -> str:
    """Gate a rank's KV leaf ``shape`` after the mesh's decode steps: its
    rows, and with ``seq_shard`` its block of ``max_len`` positions of
    every KV head (the sequence split over ``model``), without it every
    position of the KV heads its query heads read (``local_heads``).
    Returns the layout's name."""
    from repro_torch.models import attention
    from repro_torch.runtime import spmd

    ax = LM(cfg).cache_spec()["k"]
    heads_ax = transformer.cache_heads(cfg)["k"].axis
    data = mesh.shape["data"]
    rows = batch // data if batch % data == 0 else batch
    if seq_shard:
        name, want = "sequence block", (rows, max_len // mesh.shape["model"], cfg.n_kv_heads)
    else:
        with spmd.use_partition(spmd.Partition(mesh)):
            local = attention.local_heads(transformer.attn_spec(cfg))
        name, want = "every position", (rows, max_len,
                                        cfg.n_kv_heads if local is None else local[2])
    got = (shape[ax.batch], shape[ax.seq], shape[heads_ax])
    if got != want:
        raise AssertionError(f"mesh serve: the KV cache {shape} is not the rank's {name} "
                             f"(rows, positions, KV heads) {want}")
    return name


# mesh_long: llama3.2-1b at MESH_SERVE_LAYERS and batch 4 over a KV cache
# of decode_32k's length filled from a seed, LONG_STEPS greedy steps at its
# last positions, so every rank's block of positions is read; v carries a
# seeded offset a LONG_SEGMENT positions, so each block's p · v partial is
# far from 0 (with zero-mean v the output would be a near-zero mean of
# noise, and a lost block would not move the logits past LOGIT_TOL)
LONG_LEN, LONG_STEPS, LONG_BATCH, LONG_SEED, LONG_SEGMENT = 32_768, 8, 4, 1234, 4_096


def _long_cache(cfg, mesh=None, drop: int = 0) -> dict:
    """The whole seeded bf16 KV cache (L, LONG_BATCH, LONG_LEN, KV, hd),
    built a layer at a time: k standard normal, v standard normal plus a
    standard normal offset for each LONG_SEGMENT positions (of each layer,
    KV head and channel); with ``drop``, v zero at the first ``drop``
    positions (what a rank whose ``p · v`` partial was lost would
    contribute); on ``mesh`` the rank's block of it as the partitioned
    decode step keeps it (``sharding.decode_cache_specs``: its rows and
    its positions of every KV head)."""
    from repro_torch.runtime import sharding

    shape = (1, LONG_BATCH, LONG_LEN, cfg.n_kv_heads, cfg.head_dim)
    segments = (1, 1, LONG_LEN // LONG_SEGMENT, 1, cfg.n_kv_heads, cfg.head_dim)
    specs = None if mesh is None else sharding.decode_cache_specs(
        {n: torch.empty(shape, device="meta") for n in ("k", "v")}, cfg, mesh, LONG_BATCH)
    layers = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        gen = torch.Generator(device="cuda").manual_seed(LONG_SEED + i)
        k = torch.randn(shape, generator=gen, device="cuda")
        v = torch.randn(shape, generator=gen, device="cuda")
        offset = torch.randn(segments, generator=gen, device="cuda")
        v = (v.unflatten(2, (segments[2], LONG_SEGMENT)) + offset).flatten(2, 3)
        v[:, :, :drop] = 0
        layer = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        del k, v
        if specs is not None:
            layer = sharding.place(layer, specs, mesh)
        for n in layers:
            layers[n].append(layer[n])
        del layer
    return {n: torch.cat(ts) for n, ts in layers.items()}


def _mesh_long(model, params, placed, mesh) -> dict:
    """mesh_long: LONG_STEPS greedy decode steps at positions LONG_LEN -
    LONG_STEPS onwards over the seeded LONG_LEN-position cache, one
    process on the whole cache and the mesh on each rank's block (fed the
    one-process run's tokens): logits within LOGIT_TOL, greedy agreement,
    MESH_SERVE_LAYERS · 7 launches a step, a rank's cache bytes against
    the whole cache's (a quarter on (2, 2)), seconds, peak, collective
    bytes by kind.  The control ``drop``, one process with v zero on the
    first ``model`` rank's block of positions (that rank's ``p · v``
    partial lost), must move the logits past LOGIT_TOL, so the gate sees
    a lost block."""
    from repro_torch.runtime import spmd

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(LONG_SEED)
    feeds = [torch.randint(0, cfg.vocab, (LONG_BATCH, 1), generator=gen, device="cuda")]
    start, out, logits, tokens = LONG_LEN - LONG_STEPS, {}, {}, {}
    block = LONG_LEN // mesh.shape["model"]
    with torch.inference_mode():
        for run, p, m, drop in (("one", params, None, 0), ("drop", params, None, block),
                                ("mesh", placed, mesh, 0)):
            cache = _long_cache(cfg, m, drop)
            cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
            decode = steps_mod.make_decode_step(model, mesh=m, seq_len=LONG_LEN)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            logs, toks = [], []
            with spmd.count_collectives() as moved:
                for t in range(LONG_STEPS):
                    nxt, lg, cache = decode(p, cache, feeds[t], start + t)
                    if run == "one":
                        feeds.append(nxt.reshape(LONG_BATCH, 1))
                    toks.append(nxt.reshape(-1))
                    logs.append(lg[..., :cfg.vocab].float())
            torch.cuda.synchronize()
            logits[run], tokens[run] = torch.stack(logs), torch.stack(toks)
            out[run] = {"launches": {k: mod.launches for k, mod in COUNTERS.items()},
                        "seconds": time.perf_counter() - t0, "cache_bytes": cache_bytes,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                        "collective_bytes": {k: v for k, v in moved.items()
                                             if k in ("all-gather", "all-reduce", "all-to-all")},
                        "collective_counts": moved.get("counts", {})}
            del cache
            torch.cuda.empty_cache()
    err = (logits["mesh"] - logits["one"]).abs().max().item()
    scale = logits["one"].abs().max().item()
    drop_err = (logits["drop"] - logits["one"]).abs().max().item()
    out.update({"max_abs_err": err, "max_abs_logit": scale, "tol": LOGIT_TOL * scale,
                "drop_abs_err": drop_err,
                "greedy_agreement": (tokens["mesh"] == tokens["one"]).float().mean().item(),
                "drop_greedy_agreement": (tokens["drop"] == tokens["one"]).float().mean().item(),
                "positions": [start, LONG_LEN - 1]})
    want = {"sod_matmul": MESH_SERVE_LAYERS * 7 * LONG_STEPS, "block_matmul": 0,
            "decompress": 0}
    if out["mesh"]["launches"] != want:
        raise AssertionError(f"mesh_long launches {out['mesh']['launches']}, want {want}")
    quarter = out["one"]["cache_bytes"] // math.prod(MESH_SHAPE)
    if out["mesh"]["cache_bytes"] != quarter:
        raise AssertionError(f"mesh_long: a rank's cache {out['mesh']['cache_bytes']} B, "
                             f"want {quarter}")
    if not (torch.isfinite(logits["mesh"]).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"mesh_long logits {err} > {LOGIT_TOL} x {scale}")
    if not drop_err > LOGIT_TOL * scale:
        raise AssertionError(f"mesh_long: a lost block moved the logits {drop_err}, within "
                             f"{LOGIT_TOL} x {scale}: the gate cannot see it")
    return out


def _f32(tree):
    """A parameter tree with its float leaves (a packed leaf's values) in
    float32."""
    if isinstance(tree, TiledCSC):
        return dataclasses.replace(tree, vals=tree.vals.float())
    if isinstance(tree, BlockCSR):
        return dataclasses.replace(tree, block_vals=tree.block_vals.float())
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_f32(v) for v in tree)
    return tree.float() if tree.is_floating_point() else tree


def _mesh_grads(mesh, argv=TILED_ARGV, layers: int = MESH_TRAIN_LAYERS,
                prepared=None, seq: int = MESH_TRAIN_SEQ, floor: bool = False) -> dict:
    """loss_and_grads at full width, ``layers`` layers, batch 4 x ``seq``
    (128 by default, M = 512): one process on the whole weights, the mesh
    on the resident blocks (``prepared``: the model and whole weights,
    else prepared from ``argv``), every gradient within MESH_GRAD_TOL of
    one process's.  With ``floor`` one process also runs the same weights
    in float32, and a leaf whose bf16 gradient lies further than
    MESH_GRAD_TOL from its float32 one (its ``floor``) is held within
    MESH_GRAD_FLOOR_X floors instead."""
    from repro_torch.runtime import sharding, spmd

    from repro_torch.core.tree import leaves_with_path

    if prepared is None:
        args = serve.parse_args(argv)
        cfg = configs.get_config(args.arch).with_(n_layers=layers)
        prepared = serve.prepare(args, None, cfg)[:2]
    model, params = prepared
    specs = sharding.param_specs(params, model.cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    batch = to_device(SyntheticLMData(model.cfg, MESH_TRAIN_BATCH, seq, seed=0).batch(0),
                      "cuda")
    loss1, _, g1 = steps_mod.make_loss_and_grads(model)(params, batch)
    floors = {}
    if floor:
        g32 = steps_mod.make_loss_and_grads(LM(model.cfg.with_(dtype="float32")))(
            _f32(params), batch)[2]
        floors = {path: (a.float() - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30)
                  for (path, a), (_, b) in zip(leaves_with_path(g1), leaves_with_path(g32))
                  if a.is_floating_point()}
        del g32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with registry.count_dispatches() as counts, spmd.count_collectives() as moved:
        loss, _, g = steps_mod.make_loss_and_grads(model, mesh=mesh)(placed, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    whole = sharding.unplace(g, specs, mesh)
    errs = {}
    for (path, got), (path1, want) in zip(leaves_with_path(whole), leaves_with_path(g1)):
        if path != path1 or got.shape != want.shape:
            raise AssertionError(f"mesh grads: {path} {tuple(got.shape)} against "
                                 f"{path1} {tuple(want.shape)}")
        if got.is_floating_point():
            scale = want.float().abs().max().item()
            errs[path] = (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)
    worst, n = max(errs.values()), len(errs)
    tols = {path: max(MESH_GRAD_TOL, MESH_GRAD_FLOOR_X * floors.get(path, 0.0))
            for path in errs}
    over = {path: (e, tols[path]) for path, e in errs.items() if e > tols[path]}
    rel_loss = abs(loss.item() - loss1.item()) / abs(loss1.item())
    row = {"loss": loss.item(), "loss_one_process": loss1.item(), "rel_loss_err": rel_loss,
           "grad_rel_err": worst, "grads_compared": n, "m": MESH_TRAIN_BATCH * seq,
           "worst_leaves": [(path, e, floors.get(path)) for path, e in
                            sorted(errs.items(), key=lambda kv: -kv[1])[:4]],
           "leaves_past_mesh_grad_tol": sum(e > MESH_GRAD_TOL for e in errs.values()),
           "step_s": step_s, "peak_mem_gb": peak,
           "launches": {k: mod.launches for k, mod in COUNTERS.items()},
           "dispatch": counts, "collective_bytes": moved}
    if rel_loss > MESH_LOSS_TOL or over:
        raise AssertionError(f"mesh grads: loss {rel_loss}, grads past their tolerance {over}")
    return row


# phase 15: the rest of the distributed runtime, in phase 14's rank group
# the engine at 4 layers: its static reference decodes every request at
# batch 1, which at 16 layers took 45 s of the script on an H100
MESH_ENGINE_LAYERS, MESH_ENGINE_GEN = 4, 8
MOE_MESH_ARCH, MOE_MESH_LAYERS, MOE_MESH_GEN = "qwen2-moe-a2.7b", 4, 8
# run -> (one process's config fields, the mesh's): the all-to-all over
# ``model`` (4 token shards) against the capacity dispatch in 4 blocks, and
# the capacity dispatch in 2 blocks (the data size) on both
MOE_MESH_RUNS = {"a2a": ({"moe_dispatch_blocks": 4},
                         {"moe_dispatch_blocks": 4, "moe_a2a_axis": "model"}),
                 "capacity": ({"moe_dispatch_blocks": 2}, {"moe_dispatch_blocks": 2})}
# the rank's seconds in _mesh_moe when MoE's steps ran whole rows (PR 29's
# final run; an NVIDIA H100 80GB HBM3 at 700.00 W): one a2a run
MOE_WHOLE_ROWS_S = 16.9
# arch -> (layers, serve flags): the audio and VLM families on the mesh
FRONTEND_MESH_CELLS = {"musicgen-medium": (4, ["--batch", "4", "--prompt-len", "32"]),
                       "pixtral-12b": (2, ["--batch", "2", "--prompt-len", "1536"])}
# arch -> (layers, loss_and_grads seq): the recurrent families on the mesh
# at full width, one group each (zamba2: 6 Mamba2 blocks and the shared
# block, 40 Mamba2 and 16 attention heads a rank; xlstm: 3 mLSTM blocks and
# an sLSTM, 2 mLSTM heads a rank); xlstm's gradient batch cut to 4 x 64,
# its sLSTM's host time loop setting its time
RECURRENT_MESH_CELLS = {"zamba2-2.7b": (6, MESH_TRAIN_SEQ), "xlstm-125m": (4, 64)}
ELASTIC_FAILED = (2, 3)             # the ranks the elastic part loses
DRY_CELL = ("llama3.2-1b", "train_4k", "tiled_csc")
# the reference's record of DRY_CELL on a rank of its 16 x 16 mesh (XLA's
# memory and cost analyses and its partitioned HLO's collectives;
# benchmarks/results/dryrun/llama3.2-1b__train_4k__16x16__tiled_csc.json)
DRY_REFERENCE = {"flops": 5.32e13, "argument_bytes": 2.19e8, "peak_bytes": 1.48e10,
                 "all-gather": 1.26e11, "total": 3.01e11}
# the whole-rows program's counts of the same cell (on the card, equal to
# a CPU's): every plain op on the global batch, plain leaves whole
DRY_WHOLE_ROWS = {"flops": 3.950545278599168e15, "argument_bytes": 4387276100,
            "peak_bytes": 3362457199952, "all-gather": 2290157092864,
            "total": 2427965145096}
DRY_PEAK_LIMIT = 40e9                # half the card's 80 GB
DRY_MOE_CELL = ("granite-moe-1b-a400m", "train_4k", None)
# the parent tree's counts of DRY_MOE_CELL (MoE's steps on whole rows, the
# routed experts gathered whole; this sandbox's CPU, equal to a card's)
DRY_MOE_WHOLE_ROWS = {"flops": 5.81e15, "argument_bytes": 3.15e8, "peak_bytes": 1.30e12,
                      "all-gather": 2.83e9}
# a rank's share: 1.5 × the whole-rows flops over the 256 ranks
DRY_MOE_FLOPS_LIMIT = 3.4e13
DRY_FLOPS_BAND = (0.67, 1.5)         # a rank's flops over the reference's
DRY_HYBRID_CELL = ("zamba2-2.7b", "train_4k", None)
# the whole-rows program's counts of DRY_HYBRID_CELL, before the hybrid's
# steps were partitioned (every plain op on the global batch on every rank;
# counted on a CPU, equal to a card's)
DRY_HYBRID_WHOLE_ROWS = {"flops": 2.837e16, "argument_bytes": 5.130e8, "peak_bytes": 5.324e12,
                         "all-gather": 5.145e9}
# a rank's share: 1.5 × the whole-rows flops over the 256 ranks
DRY_HYBRID_FLOPS_LIMIT = 1.7e14
# the decode cell, counted with the KV cache's sequence over ``model`` (the
# reference's dry-run default) and with SOD_SEQ_SHARD_CACHE=0 (every
# position on the rank, the rows-and-heads layout: 8.76e9 argument bytes a
# rank)
DRY_DECODE_CELL = ("llama3.2-1b", "decode_32k", "tiled_csc")
DRY_DECODE_WHOLE_SEQ_ARGS = 8.76e9
DRY_DECODE_ARG_LIMIT = 1e9
DRY_DECODE_STATS_LIMIT = 1e8         # collective bytes the split may add


def _mesh_engine(mesh) -> dict:
    """``Engine(mesh=)`` on llama3.2-1b's resident blocks (tiled_csc, full
    width, MESH_ENGINE_LAYERS layers): phase 4's four prompts as requests
    of MESH_ENGINE_GEN tokens, every request's tokens bit-equal to the mesh
    static decode; ``sod_matmul`` launched, no other kernel, only
    ``cuda_fused`` dispatched, under mesh keys."""
    from repro_torch.runtime import sharding, spmd
    from repro_torch.serving import Request

    args = serve.parse_args(TILED_ARGV)
    cfg = configs.get_config(args.arch).with_(n_layers=MESH_ENGINE_LAYERS)
    model, params, tokens, *_ = serve.prepare(args, None, cfg)
    placed = sharding.place(params, sharding.param_specs(params, model.cfg, mesh), mesh)
    kernel = "sod_matmul"

    reqs = [Request(rid=i, tokens=tokens[i].tolist(), max_new=MESH_ENGINE_GEN, arrival=0)
            for i in range(tokens.shape[0])]
    impl = "cuda_fused"
    with torch.inference_mode():
        reset_counts()
        with registry.record_dispatches() as log:
            t0 = time.perf_counter()
            got = Engine(model, placed, max_slots=4, page_size=16, max_len=64,
                         mesh=mesh).run(reqs)["tokens"]
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
        launches = {k: mod.launches for k, mod in COUNTERS.items()}
        static = {r.rid: mesh_static_generate(model, placed, r, mesh) for r in reqs}
    got = {int(k): list(v) for k, v in got.items()}
    if got != static:
        raise AssertionError(f"rank {mesh.rank}: engine on the mesh {got} != static {static}")
    others = {k: v for k, v in launches.items() if k != kernel}
    if not launches[kernel] or any(others.values()) or {r["impl"] for r in log} != {impl} \
            or not all(r["key"].mesh.startswith(spmd.mesh_key(mesh) + "|") for r in log):
        raise AssertionError(f"rank {mesh.rank}: engine launches {launches}, dispatched "
                             f"{sorted({(r['impl'], r['key'].mesh) for r in log})}")
    return {"requests": len(reqs), "tokens_equal": True, "launches": launches,
            "engine_s": engine_s}


def _mesh_moe(mesh, workdir: str) -> dict:
    """qwen2-moe-a2.7b at full width and MOE_MESH_LAYERS layers: the plan on
    its seeded raw weights with the routed entries dropped (attention and
    the shared expert packed, fault R4), then prefill of 4 × 32 tokens and
    MOE_MESH_GEN greedy decode steps through the partitioned steps (a
    rank's rows, its ``E / tp`` routed experts), twice (MOE_MESH_RUNS):
    the all-to-all over ``model`` against one process's capacity dispatch
    in as many blocks as token shards (4), and the capacity dispatch in 2
    blocks (the data size) against one process's in 2; every token routed
    as the one process chose: logits within LOGIT_TOL, greedy agreement,
    the routing choices the mesh's own router would have made otherwise,
    each rank's all-to-all count above 0 in the first run and none in the
    second, the launches derived from the plan, the mesh run's seconds and
    a rank's peak memory."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding

    base = ["--arch", MOE_MESH_ARCH, *FAMILY_BASE, *FAMILY_TILED]
    args = serve.parse_args(base)
    cfg = configs.get_config(MOE_MESH_ARCH).with_(n_layers=MOE_MESH_LAYERS)
    # two ranks plan and pack at a time: a packing's peak (≈ 20 GB) on all
    # four at once does not fit the card
    for wave in range(2):
        if mesh.rank % 2 == wave:
            plan_path, plan_row = _moe_plan(
                f"mesh_moe_rank{mesh.rank}", cfg,
                SoDConfig(mode=args.sod, density=args.density, min_dim=64), args.seed,
                serve.m_values(args, cfg), workdir)
            model, params, tokens, plan = serve.prepare(
                serve.parse_args(base + ["--plan", plan_path]), None, cfg)[:4]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    if not all(isinstance(layer["moe"][n], torch.Tensor)
               for layer in params["layers"] for n in moe.ROUTED):
        raise AssertionError(f"rank {mesh.rank}: a routed expert was packed")
    placed = sharding.place(params, sharding.param_specs(params, model.cfg, mesh), mesh)
    per_forward = (sum(len(_packed_paths(layer)) for layer in params["layers"])
                   + isinstance(params.get("head"), (TiledCSC, BlockCSR)))
    out = {"plan": plan_row, "per_forward": per_forward}
    for run, (one, on_mesh) in MOE_MESH_RUNS.items():
        row = _mesh_serve(LM(model.cfg.with_(**one)), params, placed, tokens, "sod_matmul",
                          mesh, per_forward=per_forward, gen=MOE_MESH_GEN, plan=plan,
                          mesh_model=LM(model.cfg.with_(**on_mesh)), pin_routing=True)
        calls = row["mesh"]["collectives"].get("counts", {}).get("all-to-all", 0)
        if bool(calls) != ("moe_a2a_axis" in on_mesh):
            raise AssertionError(f"rank {mesh.rank} {run}: {calls} all-to-all calls")
        out[run] = {**row, "all_to_all_calls": calls,
                    "all_to_all_bytes": row["mesh"]["collectives"].get("all-to-all", 0)}
    return out


def mesh_frontends(mesh) -> dict:
    """The audio and VLM families' partitioned steps at full width
    (tiled_csc, phase 12's flags): musicgen-medium at FRONTEND_MESH_LAYERS
    (4), prefill of 4 × 32 (4 codebook streams) and MESH_GEN decode steps
    against one process (logits within LOGIT_TOL, greedy agreement), then
    ``loss_and_grads`` at batch 4 × 128 against one process (the loss, and
    every gradient after ``unplace``, within MESH_LOSS_TOL and
    MESH_GRAD_TOL); pixtral-12b at 2 layers, a prefill of 2 × (1024
    patches + 512 text) and MESH_GEN decode steps from the true end
    (n_patches + the text; the serve driver keeps R5) against one
    process.  Each: launches (layers · 7 + the head) × (1 + MESH_GEN), a
    rank's peak memory and seconds."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding

    out = {}
    for arch, (layers, flags) in FRONTEND_MESH_CELLS.items():
        argv = ["--arch", arch, *flags, "--seed", "0", "--device", "cuda", *FAMILY_TILED]
        cfg = configs.get_config(arch).with_(n_layers=layers)
        t0 = time.perf_counter()
        for wave in range(mesh.size):  # one rank packs at a time (pixtral's head)
            if mesh.rank == wave:
                prep = serve.prepare(serve.parse_args(argv), None, cfg)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        model, params = prep.model, prep.params
        placed = sharding.place(params, sharding.param_specs(params, model.cfg, mesh), mesh)
        pack_s = time.perf_counter() - t0
        row = _mesh_serve(model, params, placed, prep.tokens, "sod_matmul", mesh,
                          per_forward=layers * 7 + 1, gen=MESH_GEN,
                          patch_embeds=prep.patch_embeds)
        out[arch] = {"serve": row, "pack_s": pack_s, "layers": layers}
        del placed, prep
        if model.cfg.family == "audio":
            torch.cuda.empty_cache()
            out[arch]["grads"] = _mesh_grads(mesh, prepared=(model, params))
        del model, params
        torch.cuda.empty_cache()
    return out


def mesh_recurrent(mesh) -> dict:
    """The recurrent families' partitioned steps at full width (tiled_csc,
    phase 11's flags), each rank packing alone: RECURRENT_MESH_CELLS'
    zamba2-2.7b (6 layers) and xlstm-125m (4 layers), a prompt of 4 × 32
    stepped through the partitioned decode step and MESH_GEN decode steps
    against one process (logits within LOGIT_TOL, greedy agreement, the
    launches phase 11 derives a step times the steps), then
    ``loss_and_grads`` at batch 4 × the cell's seq against one process
    (the loss, and every gradient after ``unplace``, within MESH_LOSS_TOL
    and MESH_GRAD_TOL, or MESH_GRAD_FLOOR_X times the leaf's own bf16
    distance from its float32 gradient where that is larger); a rank's
    peak memory and seconds."""
    import torch.distributed as dist

    from repro_torch.runtime import sharding, spmd

    out = {}
    for arch, (layers, seq) in RECURRENT_MESH_CELLS.items():
        argv = ["--arch", arch, *FAMILY_BASE, *FAMILY_TILED]
        cfg = configs.get_config(arch).with_(n_layers=layers)
        t0 = time.perf_counter()
        for wave in range(mesh.size):
            if mesh.rank == wave:
                prep = serve.prepare(serve.parse_args(argv), None, cfg)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        model, params = prep.model, prep.params
        placed = sharding.place(params, sharding.param_specs(params, model.cfg, mesh), mesh)
        pack_s = time.perf_counter() - t0
        n_heads = (transformer.mamba_spec(model.cfg).n_heads if model.cfg.family == "hybrid"
                   else model.cfg.n_heads)
        with spmd.use_partition(spmd.Partition(mesh, ("data",))):
            heads = spmd.model_block(n_heads)
        per_step = _recurrent_per_step(model.cfg)
        t0 = time.perf_counter()
        row = _mesh_serve(model, params, placed, prep.tokens, "sod_matmul", mesh,
                          per_forward=per_step, gen=MESH_GEN)
        serve_s = time.perf_counter() - t0
        del placed, prep
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        grads = _mesh_grads(mesh, prepared=(model, params), seq=seq, floor=True)
        out[arch] = {"serve": row, "grads": grads, "layers": layers, "per_step": per_step,
                     "heads_a_rank": None if heads is None else heads[1],
                     "pack_s": pack_s, "serve_s": serve_s,
                     "grads_s": time.perf_counter() - t0}
        del model, params
        torch.cuda.empty_cache()
    return out


def _mesh_elastic(mesh, workdir: str) -> dict:
    """Two mesh train steps at full width and MESH_TRAIN_LAYERS layers, the
    whole state saved (``sharding.unplace``); then ranks ELASTIC_FAILED
    leave, the survivors re-mesh (``fault.surviving_mesh``: (1, 2)),
    restore onto it (``restore(shardings=)``) and take one step.  Its loss
    within ELASTIC_LOSS_TOL of one process's on the same checkpoint (the
    new rank 0 takes that step too), the whole state after it
    (``sharding.unplace``: parameters, moments, masters) within
    ELASTIC_STATE_TOL leaf by leaf and its step counter equal; its
    launches derived from the config."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import fault, sharding, spmd

    args = serve.parse_args(TILED_ARGV)
    cfg = configs.get_config(args.arch).with_(n_layers=MESH_TRAIN_LAYERS)
    model, params, *_ = serve.prepare(args, None, cfg)
    opt = AdamW(AdamWConfig(lr=1e-4))
    specs = sharding.param_specs(params, model.cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    state = opt.init(placed)
    data = SyntheticLMData(model.cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, seed=0)
    step = steps_mod.make_train_step(model, opt, mesh=mesh)
    losses = []
    for i in range(2):
        placed, state, metrics = step(placed, state, to_device(data.batch(i), "cuda"))
        losses.append(float(metrics["loss"]))
    t0 = time.perf_counter()
    whole = sharding.unplace({"params": placed, "opt": state},
                             sharding.train_state_specs(specs), mesh)
    ck = Checkpointer(pathlib.Path(workdir) / "elastic")
    if mesh.rank == 0:
        ck.save(2, whole)
    del whole
    dist.barrier()
    save_s = time.perf_counter() - t0
    if mesh.rank in ELASTIC_FAILED:
        dist.destroy_process_group()
        return {"failed": True, "losses": losses, "save_s": save_s}
    t0 = time.perf_counter()
    new = fault.surviving_mesh(range(mesh.size), set(ELASTIC_FAILED), mesh.shape["model"],
                               device="cuda")
    new_specs = sharding.train_state_specs(sharding.param_specs(params, model.cfg, new))
    restored = ck.restore(2, {"params": placed, "opt": state}, shardings=(new_specs, new))
    del placed, state
    remesh_s = time.perf_counter() - t0
    batch = to_device(data.batch(2), "cuda")
    reset_counts()
    with registry.count_dispatches() as counts, spmd.count_collectives() as moved:
        p, s, metrics = steps_mod.make_train_step(model, opt, mesh=new)(
            restored["params"], restored["opt"], batch)
    loss = float(metrics["loss"])
    launches = {k: mod.launches for k, mod in COUNTERS.items()}
    del restored
    after = sharding.unplace({"params": p, "opt": s}, new_specs, new)
    del p, s
    # each packed product: its kernel forward and one decompress in the
    # backward; under remat the replay of a block runs all 7 again (the
    # partitioned step's kernels save their inputs through the checkpoint,
    # the last product's too; the whole-rows program kept that one's graph:
    # 6 of 7)
    packed = MESH_TRAIN_LAYERS * 7
    want = {"sod_matmul": packed + (MESH_TRAIN_LAYERS * 7 if model.cfg.remat else 0),
            "block_matmul": 0, "decompress": packed}
    row = {"failed": False, "new_rank": new.rank, "new_shape": list(new.axis_sizes),
           "losses": losses, "loss": loss, "launches": launches, "want_launches": want,
           "dispatch": counts, "collective_bytes": {k: moved.get(k, 0) for k in
                                                    ("all-gather", "all-reduce")},
           "save_s": save_s, "remesh_restore_s": remesh_s}
    if new.rank == 0:       # one process on the same checkpoint, the same step
        one = ck.restore(2, {"params": params, "opt": opt.init(params)})
        p1, s1, m1 = steps_mod.make_train_step(model, opt)(one["params"], one["opt"], batch)
        del one
        row["loss_one_process"] = float(m1["loss"])
        row["rel_loss_err"] = abs(loss - row["loss_one_process"]) / abs(row["loss_one_process"])
        row["state_err"] = state_dist(after, {"params": p1, "opt": s1})
        worst = max(v for k, v in row["state_err"].items() if k != "step_equal")
        if not (row["rel_loss_err"] <= ELASTIC_LOSS_TOL and worst <= ELASTIC_STATE_TOL
                and row["state_err"]["step_equal"]):
            raise AssertionError(f"elastic step: loss {loss} vs one process "
                                 f"{row['loss_one_process']}, state {row['state_err']}")
    if launches != want or {k.split("[")[0] for k in counts} != {"cuda_fused"}:
        raise AssertionError(f"elastic step: launches {launches} (want {want}), "
                             f"dispatched {counts}")
    return row


def _dry_cell(arch: str, shape: str, sod, seq_shard: str = "1") -> dict:
    """One dry-run cell on rank 0 of the 16 × 16 counting mesh, on meta
    tensors: nothing launches.  ``seq_shard`` is the cell's
    ``SOD_SEQ_SHARD_CACHE`` (its own process's)."""
    from repro_torch.launch import dryrun

    os.environ["SOD_SEQ_SHARD_CACHE"] = seq_shard
    torch.set_num_threads(1)
    before = {k: mod.launches for k, mod in COUNTERS.items()}
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, False, sod, DENSITY)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: mod.launches - before[k] for k, mod in COUNTERS.items()}
    return rec


def _dry_cells() -> dict:
    """The dry-run cells (DRY_CELL, DRY_MOE_CELL, DRY_HYBRID_CELL, keyed by
    arch; DRY_DECODE_CELL with the sequence split, ``decode_32k``, and
    without, ``decode_32k_whole_seq``, one after the other), each in a
    spawned process of its own, so they take a host core each beside the
    rank group (one after the other they took 184 s beside it on an H100's
    host)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cells = (DRY_CELL, DRY_MOE_CELL, DRY_HYBRID_CELL)
    with ProcessPoolExecutor(len(cells) + 1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        done = [pool.submit(_dry_cell, *cell) for cell in cells]
        decode = pool.submit(_dry_decode_cells)
        return {**{cell[0]: f.result() for cell, f in zip(cells, done)}, **decode.result()}


def _dry_decode_cells() -> dict:
    return {"decode_32k": _dry_cell(*DRY_DECODE_CELL),
            "decode_32k_whole_seq": _dry_cell(*DRY_DECODE_CELL, seq_shard="0")}


def mesh_rank(workdir: str, t_launch: str) -> dict:
    """One rank of phases 14 and 15 (started by :func:`phase_mesh` through
    ``launch.mesh.run_ranks``): the cells' ops, serving, the engine and the
    training step's gradients on a (2, 2) mesh over ``gloo``, then MoE's
    all-to-all and the elastic re-mesh, the kernels the build phase
    built."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import sharding

    _backend_flags()
    mesh = mesh_mod.make_test_mesh(MESH_SHAPE, device="cuda")
    rebuilt = {k: v for k, v in build.build_all().items() if v}
    if rebuilt:
        raise AssertionError(f"rank {mesh.rank} built {sorted(rebuilt)} again")
    seconds = {"start": time.time() - float(t_launch)}
    out = {"rank": mesh.rank, "coords": mesh.coords, "cells": {}}
    for cell, (argv, sod, kernel) in MESH_CELLS.items():
        t0 = time.perf_counter()
        args = serve.parse_args(argv)
        model, params, tokens, *_ = serve.prepare(
            args, sod, configs.get_config(args.arch).with_(n_layers=MESH_SERVE_LAYERS))
        placed = sharding.place(params, sharding.param_specs(params, model.cfg, mesh), mesh)
        torch.cuda.synchronize()
        packed = [w for ws in _projections(params).values() for w in ws]
        resident = [w for ws in _projections(placed).values() for w in ws]
        seconds["pack"] = seconds.get("pack", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        ops_row = _mesh_ops(params["layers"][0], kernel, mesh)
        seconds["ops"] = seconds.get("ops", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_row = _mesh_serve(model, params, placed, tokens, kernel, mesh)
        if cell == MESH_WHOLE_SEQ_CELL:   # and at the unrounded length, unsplit
            out["whole_seq"] = _mesh_serve(model, params, placed, tokens, kernel, mesh,
                                           seq_shard=False)
        seconds["serve"] = seconds.get("serve", 0.0) + time.perf_counter() - t0
        if cell == "mesh_tiled_csc":
            t0 = time.perf_counter()
            out["long"] = _mesh_long(model, params, placed, mesh)
            seconds["long"] = time.perf_counter() - t0
        out["cells"][cell] = {
            "kernel": kernel, "ops": ops_row, "serve": serve_row,
            "resident_bytes": sum(w.nbytes_compressed() for w in resident),
            "whole_bytes": sum(w.nbytes_compressed() for w in packed),
            "dense_bytes": sum(w.nbytes_dense() for w in packed)}
        del model, params, placed, packed, resident
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["grads"] = {**_mesh_grads(mesh), "whole_rows_step_s": WHOLE_ROWS["grads_step_s"],
                    "whole_rows_peak_mem_gb": WHOLE_ROWS["grads_peak_mem_gb"]}
    seconds["grads"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["engine"] = _mesh_engine(mesh)
    seconds["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["moe"] = _mesh_moe(mesh, workdir)
    seconds["moe"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["frontends"] = mesh_frontends(mesh)
    seconds["frontends"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["recurrent"] = mesh_recurrent(mesh)
    seconds["recurrent"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["elastic"] = _mesh_elastic(mesh, workdir)     # last: it ends the group
    seconds["elastic"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def phase_mesh() -> dict:
    """Phase 14: four ranks on the card, a (2, 2) (data, model) mesh over
    ``gloo`` (see ROADMAP.md: NCCL takes one rank a device)."""
    from repro_torch.launch import mesh as mesh_mod

    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    # phase 15's dry-run cells run on the host beside the rank group
    with ThreadPoolExecutor(max_workers=1) as pool:
        dry = pool.submit(_dry_cells)
        try:
            ranks = mesh_mod.run_ranks(
                math.prod(MESH_SHAPE), f"{pathlib.Path(__file__).resolve()}:mesh_rank", work,
                args=(work, repr(time.time())), timeout=MESH_TIMEOUT_S)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        wall = time.perf_counter() - t0
        dry = dry.result()
    dry_s = time.perf_counter() - t0
    for r in ranks:
        for cell, row in r["cells"].items():
            disp = row["serve"]["mesh"]["dispatch"]
            impl = {"sod_matmul": "cuda_fused", "block_matmul": "cuda_block"}[row["kernel"]]
            if {k.split("[")[0] for k in disp} != {impl}:
                raise AssertionError(f"rank {r['rank']} {cell}: dispatched {disp}")
            if not row["resident_bytes"] < row["whole_bytes"]:
                raise AssertionError(f"rank {r['rank']} {cell}: resident bytes "
                                     f"{row['resident_bytes']} not below {row['whole_bytes']}")
            log({"phase": "mesh", "rank": r["rank"], "coords": r["coords"], "cell": cell,
                 "dispatch": disp, "launches": row["serve"]["mesh"]["launches"],
                 "mesh_serve_s": row["serve"]["mesh"]["seconds"],
                 "peak_mem_gb_a_rank": row["serve"]["mesh"]["peak_mem_gb"],
                 "whole_rows_serve_s_both_cells": WHOLE_ROWS["serve_s_both_cells"],
                 "whole_rows_peak_mem_gb_a_rank": "not measured",
                 "max_abs_err": row["serve"]["max_abs_err"], "tol": row["serve"]["tol"],
                 "greedy_agreement": row["serve"]["greedy_agreement"],
                 "prefill_tokens_equal": row["serve"]["prefill_tokens_equal"],
                 "resident_bytes": row["resident_bytes"], "whole_bytes": row["whole_bytes"],
                 "ops": row["ops"]})
        ws = r["whole_seq"]
        log({"phase": "mesh_whole_seq", "rank": r["rank"], "cell": MESH_WHOLE_SEQ_CELL,
             "max_len": ws["max_len"], "kv_shape": ws["mesh"]["kv_shape"],
             "kv_layout": ws["kv_layout"], "launches": ws["mesh"]["launches"],
             "mesh_serve_s": ws["mesh"]["seconds"], "max_abs_err": ws["max_abs_err"],
             "tol": ws["tol"], "greedy_agreement": ws["greedy_agreement"],
             "prefill_tokens_equal": ws["prefill_tokens_equal"]})
        lg = r["long"]
        log({"phase": "mesh_long", "rank": r["rank"], "arch": "llama3.2-1b",
             "layers": MESH_SERVE_LAYERS, "batch": LONG_BATCH, "cache_len": LONG_LEN,
             "positions": lg["positions"], "max_abs_err": lg["max_abs_err"], "tol": lg["tol"],
             "greedy_agreement": lg["greedy_agreement"],
             "lost_block_abs_err": lg["drop_abs_err"],
             "lost_block_greedy_agreement": lg["drop_greedy_agreement"],
             "cache_bytes_a_rank": lg["mesh"]["cache_bytes"],
             "whole_cache_bytes": lg["one"]["cache_bytes"],
             "mesh_s": lg["mesh"]["seconds"], "one_process_s": lg["one"]["seconds"],
             "peak_mem_gb_a_rank": lg["mesh"]["peak_mem_gb"],
             "one_process_peak_mem_gb": lg["one"]["peak_mem_gb"],
             "launches": lg["mesh"]["launches"],
             "collective_bytes": lg["mesh"]["collective_bytes"],
             "collective_counts": lg["mesh"]["collective_counts"]})
        log({"phase": "mesh_grads", "rank": r["rank"], **r["grads"]})
        log({"phase": "mesh_seconds", "rank": r["rank"], **r["seconds"]})
    first = ranks[0]["cells"]
    for cell in first:     # every rank holds the same logits: the same error
        if len({r["cells"][cell]["serve"]["max_abs_err"] for r in ranks}) != 1:
            raise AssertionError(f"{cell}: the ranks' logits differ")
    for key in ("long", "whole_seq"):
        if len({r[key]["max_abs_err"] for r in ranks}) != 1:
            raise AssertionError(f"mesh {key}: the ranks' logits differ")
    log({"phase": "mesh", "wall_s": wall, "ranks": len(ranks)})
    out = {cell: first[cell]["serve"]["mesh"]["launches"] for cell in first}
    out["mesh_long"] = ranks[0]["long"]["mesh"]["launches"]
    out.update(_phase15(ranks, dry, dry_s))
    return out


def _phase15(ranks: list, dry: dict, dry_s: float) -> dict:
    """Phase 15's gates across the ranks and its lines: MoE's partitioned
    runs, the frontends and the recurrent families on the mesh, the engine
    on the mesh, the elastic re-mesh, the dry-run cells."""
    for r in ranks:
        for run in MOE_MESH_RUNS:
            m = r["moe"][run]
            log({"phase": "mesh_moe", "rank": r["rank"], "run": run, "arch": MOE_MESH_ARCH,
                 "layers": MOE_MESH_LAYERS, "all_to_all_calls": m["all_to_all_calls"],
                 "all_to_all_bytes": m["all_to_all_bytes"],
                 "max_abs_err": m["max_abs_err"], "tol": m["tol"],
                 "greedy_agreement": m["greedy_agreement"],
                 "prefill_tokens_equal": m["prefill_tokens_equal"],
                 "routing_differs": m["routing_differs"],
                 "mesh_serve_s": m["mesh"]["seconds"],
                 "peak_mem_gb_a_rank": m["mesh"]["peak_mem_gb"],
                 "moe_s_a_rank": r["seconds"]["moe"], "whole_rows_moe_s": MOE_WHOLE_ROWS_S,
                 "launches": m["mesh"]["launches"], "dispatch": m["mesh"]["dispatch"],
                 "plan": r["moe"]["plan"]})
        for arch, f in r["frontends"].items():
            sv = f["serve"]
            log({"phase": "mesh_frontends", "rank": r["rank"], "arch": arch,
                 "layers": f["layers"], "pack_s": f["pack_s"],
                 "max_abs_err": sv["max_abs_err"], "tol": sv["tol"],
                 "greedy_agreement": sv["greedy_agreement"],
                 "prefill_tokens_equal": sv["prefill_tokens_equal"],
                 "mesh_serve_s": sv["mesh"]["seconds"],
                 "peak_mem_gb_a_rank": sv["mesh"]["peak_mem_gb"],
                 "launches": sv["mesh"]["launches"], "dispatch": sv["mesh"]["dispatch"],
                 "collective_bytes": sv["mesh"]["collectives"]})
            if "grads" in f:
                log({"phase": "mesh_frontends_grads", "rank": r["rank"], "arch": arch,
                     **f["grads"]})
        for arch, f in r["recurrent"].items():
            sv = f["serve"]
            log({"phase": "mesh_recurrent", "rank": r["rank"], "arch": arch,
                 "layers": f["layers"], "heads_a_rank": f["heads_a_rank"],
                 "pack_s": f["pack_s"], "serve_s": f["serve_s"],
                 "max_abs_err": sv["max_abs_err"], "tol": sv["tol"],
                 "greedy_agreement": sv["greedy_agreement"],
                 "prefill_tokens_equal": sv["prefill_tokens_equal"],
                 "mesh_serve_s": sv["mesh"]["seconds"],
                 "peak_mem_gb_a_rank": sv["mesh"]["peak_mem_gb"],
                 "launches": sv["mesh"]["launches"],
                 "launches_want": f"{f['per_step']} a step x (32 prompt + {MESH_GEN}) steps",
                 "dispatch": sv["mesh"]["dispatch"],
                 "collective_bytes": sv["mesh"]["collectives"]})
            log({"phase": "mesh_recurrent_grads", "rank": r["rank"], "arch": arch,
                 "grads_s": f["grads_s"], **f["grads"]})
        log({"phase": "mesh_engine", "rank": r["rank"], **r["engine"]})
        log({"phase": "mesh_elastic", "rank": r["rank"], **r["elastic"]})
    for key in ([("moe", run) for run in MOE_MESH_RUNS]
                + [("frontends", a) for a in FRONTEND_MESH_CELLS]
                + [("recurrent", a) for a in RECURRENT_MESH_CELLS]):
        errs = {(r[key[0]][key[1]].get("serve") or r[key[0]][key[1]])["max_abs_err"]
                for r in ranks}
        if len(errs) != 1:
            raise AssertionError(f"mesh {key}: the ranks' logits differ")
    survivors = [r["elastic"] for r in ranks if not r["elastic"]["failed"]]
    if [r["rank"] for r in ranks if r["elastic"]["failed"]] != list(ELASTIC_FAILED) or \
            sorted(e["new_rank"] for e in survivors) != [0, 1] or \
            any(e["new_shape"] != [1, 2] for e in survivors) or \
            len({e["loss"] for e in survivors}) != 1 or \
            not any("state_err" in e for e in survivors):
        raise AssertionError(f"elastic re-mesh: {survivors}")
    for (arch, shape, sod), rec in zip((DRY_CELL, DRY_MOE_CELL, DRY_HYBRID_CELL),
                                       dry.values()):
        impls = {k.split("[")[0] for k in rec.get("dispatch_counts", {})}
        if rec.get("status") != "ok" or any(rec["launches"].values()) or \
                impls != ({"cuda_fused"} if sod else set()):
            raise AssertionError(f"dry-run cell {arch}: {rec.get('status')} "
                                 f"{rec.get('traceback', '')[-2000:]} launches "
                                 f"{rec.get('launches')}, dispatched {impls}")
        log({"phase": "dryrun", "cell": f"{arch}__{shape}__{sod or 'dense'}",
             "device": rec["device"], "flops": rec["cost"]["flops"],
             "peak_bytes_a_rank": rec["memory"]["peak_bytes"],
             "argument_bytes": rec["memory"]["argument_bytes"],
             "collective_bytes": {k: rec["collectives"][k] for k in
                                  ("all-gather", "all-reduce", "all-to-all", "total")},
             "collective_counts": rec["collectives"]["counts"],
             "dispatch_counts": rec["dispatch_counts"], "run_s": rec["run_s"],
             "wall_s": rec["wall_s"], "with_group_s": dry_s})
    llama, granite = dry[DRY_CELL[0]], dry[DRY_MOE_CELL[0]]
    port = {"flops": llama["cost"]["flops"],
            "argument_bytes": llama["memory"]["argument_bytes"],
            "peak_bytes": llama["memory"]["peak_bytes"],
            "all-gather": llama["collectives"]["all-gather"],
            "total": llama["collectives"]["total"]}
    log({"phase": "dryrun_table", "cell": "__".join(DRY_CELL), "per_rank": {
        k: {"reference": DRY_REFERENCE[k], "port": port[k], "whole_rows": DRY_WHOLE_ROWS[k],
            "port_over_reference": port[k] / DRY_REFERENCE[k]} for k in port}})
    lo, hi = DRY_FLOPS_BAND
    if not (port["peak_bytes"] < DRY_PEAK_LIMIT
            and lo * DRY_REFERENCE["flops"] <= port["flops"] <= hi * DRY_REFERENCE["flops"]):
        raise AssertionError(f"dry-run cell: peak {port['peak_bytes']} B (limit "
                             f"{DRY_PEAK_LIMIT}), flops {port['flops']} (reference "
                             f"{DRY_REFERENCE['flops']} x {DRY_FLOPS_BAND})")
    moe_port = {"flops": granite["cost"]["flops"],
                "argument_bytes": granite["memory"]["argument_bytes"],
                "peak_bytes": granite["memory"]["peak_bytes"],
                "all-gather": granite["collectives"]["all-gather"]}
    log({"phase": "dryrun_table", "cell": "granite-moe-1b-a400m__train_4k__16x16__dense",
         "per_rank": {k: {"port": moe_port[k], "whole_rows": DRY_MOE_WHOLE_ROWS[k],
                          "port_over_whole_rows": moe_port[k] / DRY_MOE_WHOLE_ROWS[k]}
                      for k in moe_port}})
    if not (moe_port["flops"] <= DRY_MOE_FLOPS_LIMIT and moe_port["peak_bytes"] < DRY_PEAK_LIMIT):
        raise AssertionError(f"dry-run MoE cell: flops {moe_port['flops']} (limit "
                             f"{DRY_MOE_FLOPS_LIMIT}), peak {moe_port['peak_bytes']} B "
                             f"(limit {DRY_PEAK_LIMIT})")
    hybrid = dry[DRY_HYBRID_CELL[0]]
    hybrid_port = {"flops": hybrid["cost"]["flops"],
                   "argument_bytes": hybrid["memory"]["argument_bytes"],
                   "peak_bytes": hybrid["memory"]["peak_bytes"],
                   "all-gather": hybrid["collectives"]["all-gather"]}
    log({"phase": "dryrun_table", "cell": "zamba2-2.7b__train_4k__16x16__dense",
         "per_rank": {k: {"port": hybrid_port[k], "whole_rows": DRY_HYBRID_WHOLE_ROWS[k],
                          "port_over_whole_rows": hybrid_port[k] / DRY_HYBRID_WHOLE_ROWS[k]}
                      for k in hybrid_port}})
    if not (hybrid_port["flops"] <= DRY_HYBRID_FLOPS_LIMIT
            and hybrid_port["peak_bytes"] < DRY_PEAK_LIMIT):
        raise AssertionError(f"dry-run hybrid cell: flops {hybrid_port['flops']} (limit "
                             f"{DRY_HYBRID_FLOPS_LIMIT}), peak {hybrid_port['peak_bytes']} B "
                             f"(limit {DRY_PEAK_LIMIT})")
    _dry_decode_table(dry["decode_32k"], dry["decode_32k_whole_seq"])
    log({"phase": "mesh15_seconds",
         "by_rank": {r["rank"]: {k: r["seconds"].get(k) for k in
                                 ("engine", "moe", "frontends", "recurrent", "elastic")}
                     for r in ranks},
         "dryrun_s": {arch: rec["wall_s"] for arch, rec in dry.items()}})
    elastic = next(e for e in survivors if e["new_rank"] == 0)
    first = ranks[0]
    return {**{f"mesh_moe_{run}": first["moe"][run]["mesh"]["launches"]
               for run in MOE_MESH_RUNS},
            **{f"mesh_{arch}": first["frontends"][arch]["serve"]["mesh"]["launches"]
               for arch in FRONTEND_MESH_CELLS},
            **{f"mesh_{arch}": first["recurrent"][arch]["serve"]["mesh"]["launches"]
               for arch in RECURRENT_MESH_CELLS},
            "mesh_engine": first["engine"]["launches"],
            "mesh_elastic_step": elastic["launches"]}


def _dry_decode_table(split: dict, whole: dict) -> None:
    """The decode cell's ``dryrun_table`` line, the sequence split beside
    every position on the rank, and its gates: argument bytes under
    DRY_DECODE_ARG_LIMIT with the split and within 1 % of
    DRY_DECODE_WHOLE_SEQ_ARGS without, the split's extra collective bytes
    under DRY_DECODE_STATS_LIMIT, nothing launched."""
    cfg = configs.get_config(DRY_DECODE_CELL[0])
    shape = configs.SHAPES[DRY_DECODE_CELL[1]]
    # the reference's layout: rows over data (16), positions over model (16)
    ref_cache = (2 * cfg.n_layers * shape.global_batch // 16 * shape.seq_len // 16
                 * cfg.n_kv_heads * cfg.head_dim * 2)
    for name, rec in (("split", split), ("whole_seq", whole)):
        impls = {k.split("[")[0] for k in rec.get("dispatch_counts", {})}
        if rec.get("status") != "ok" or any(rec["launches"].values()) or \
                impls != {"cuda_fused"}:
            raise AssertionError(f"dry-run decode cell ({name}): {rec.get('status')} "
                                 f"{rec.get('traceback', '')[-2000:]} launches "
                                 f"{rec.get('launches')}, dispatched {impls}")
    row = {k: {"split": rec_s, "whole_seq": rec_w} for k, rec_s, rec_w in (
        ("flops", split["cost"]["flops"], whole["cost"]["flops"]),
        ("argument_bytes", split["memory"]["argument_bytes"],
         whole["memory"]["argument_bytes"]),
        ("peak_bytes", split["memory"]["peak_bytes"], whole["memory"]["peak_bytes"]),
        ("all-gather", split["collectives"]["all-gather"], whole["collectives"]["all-gather"]),
        ("all-reduce", split["collectives"]["all-reduce"], whole["collectives"]["all-reduce"]),
        ("total", split["collectives"]["total"], whole["collectives"]["total"]))}
    log({"phase": "dryrun_table", "cell": "__".join(DRY_DECODE_CELL), "mesh": "16x16",
         "per_rank": row, "reference_layout_cache_bytes": ref_cache,
         "rows_and_heads_argument_bytes": DRY_DECODE_WHOLE_SEQ_ARGS,
         "collective_counts": {"split": split["collectives"]["counts"],
                               "whole_seq": whole["collectives"]["counts"]},
         "wall_s": {"split": split["wall_s"], "whole_seq": whole["wall_s"]}})
    args = row["argument_bytes"]
    added = row["total"]["split"] - row["total"]["whole_seq"]
    if not (args["split"] < DRY_DECODE_ARG_LIMIT
            and abs(args["whole_seq"] / DRY_DECODE_WHOLE_SEQ_ARGS - 1) <= 0.01
            and 0 < added < DRY_DECODE_STATS_LIMIT):
        raise AssertionError(f"dry-run decode cell: argument bytes {args}, the split's "
                             f"collectives {added} B more")


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}
    # a cold tuning cache of this run's own: phases 4-6 dispatch the untuned
    # launches, and no user cache is read or written
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = f"{cache_dir}/tuning_cache.json"
    autotune.set_cache(None)      # opened from the variable at first use

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        log({"phase_seconds": {phase: seconds[phase]}})
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    cells = {cell: timed(f"slice:{cell}", phase_slice, cell) for cell in CELLS}
    check_quantized_bytes(cells)
    for cell in PROFILED:
        sl = cells[cell]
        timed("profile", phase_profile, cell, sl["model"], sl["params"], sl["tokens"])
    timed("profile", phase_head, cells["tiled_csc"]["params"], 4)
    engine = {run: timed(f"engine:{run}", phase_engine, run, cells)
              for run in ENGINE_RUNS}
    timed("engine_profile", phase_engine_profile, cells)
    spec_args = serve.parse_args(SPEC_ARGV)
    drafts = {cell: serve.prepare_draft(spec_args, cells[cell]["model"])[0]
              for cell in ("tiled_csc", "block_csr")}
    engine.update({run: timed(f"engine:{run}", phase_feature, run, cells, drafts)
                   for run in FEATURE_RUNS})
    timed("spec_profile", phase_spec_profile, cells, drafts["tiled_csc"])
    del drafts
    plan = timed("plan", phase_plan, cells)
    for cell in cells.values():        # free the card for training
        for key in ("model", "params", "tokens"):
            cell.pop(key, None)
    train_err, train_ms = timed("train", phase_train_grads, kern.pop("qpacks"))
    train_launches = {}
    for run in TRAIN_RUNS:
        summary = timed(f"train:{run}", train_run, run)
        train_launches[run] = summary["kernel_launches"]
        if run == "train_tiled_csc":
            timed("train_profile", phase_train_profile, summary)
        del summary
    timed("train_resume", phase_train_resume)
    family = phase_family(timed)
    moe_out = phase_moe(timed)
    rec_out = phase_recurrent(timed)
    fe_out = phase_frontends(timed)
    paper = phase_paper(timed)
    mesh_launches = timed("mesh", phase_mesh)
    shutil.rmtree(cache_dir, ignore_errors=True)

    entries = []
    for qmode in ("none", *QMODES):
        for name in ("sod_matmul", "block_matmul", "decompress"):
            launches, where = _launches_of(name, qmode, cells, kern)
            entry = {**_entry(name, qmode, kern, launches), "launches_in": where}
            if qmode == "none":
                entry["engine_launches"] = {run: row["launches"] for run, row in
                                            engine.items()
                                            if CELLS[row["cell"]][2] == name}
            runs = {run: row for run, row in plan.items() if name != "decompress"
                    and any(IMPL_KERNEL[k.split("[")[0]] == name
                            for k in row["kernel_dispatch"])
                    and (qmode in row.get("packed_qmodes", ("none",)))}
            if runs:
                entry["plan_launches"] = {run: row["launches"] for run, row in runs.items()}
                entry["plan_dispatch"] = {run: row["kernel_dispatch"]
                                          for run, row in runs.items()}
            trained = {run: launches[name] for run, launches in train_launches.items()
                       if launches[name] and _train_qmode(run) == qmode}
            if trained:
                entry["train_launches"] = trained
            if (name, qmode) in train_err:
                entry["train_grad_max_abs_err"] = train_err[(name, qmode)]
            if qmode == "none" and name in train_ms:
                entry.update({f"train_{k}": v for k, v in train_ms[name].items()})
            entry.update(_family_entry(name, qmode, family))
            entry.update(_moe_entry(name, qmode, moe_out))
            entry.update(_recurrent_entry(name, qmode, rec_out))
            entry.update(_frontend_entry(name, qmode, fe_out))
            entry.update(_paper_entry(name, qmode, paper))
            if qmode == "none":
                entry["mesh_launches"] = {cell: n[name] for cell, n in mesh_launches.items()
                                          if n[name]}
            entries.append(entry)
    log({"phase_seconds": seconds, "total_s": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
