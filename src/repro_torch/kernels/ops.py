"""Public entry points over dense and packed weights.

Twin of :mod:`repro.kernels.ops`: a dense weight flows straight to
:func:`dense_matmul` (the paper's decompression bypass, Fig. 2c); a packed
weight dispatches through the kernel registry (:mod:`repro_torch.kernels.registry`) with the autotuner's
persisted winners (:mod:`repro_torch.kernels.autotune`):

* ``impl="auto"`` — the tuned entry of this (layout, M bucket, backend) if
  the tuning cache has one, else the prior's choice: on a CUDA tensor the
  hand-written kernel of the format (``cuda_fused`` for a TiledCSC,
  ``cuda_block`` for a BlockCSR), on a CPU tensor the plain version
  (``torch_oracle``);
* ``impl="cuda"`` (``"pallas"``, the reference's spelling of the same
  choice, so its plans replay) — force the format's CUDA impl; its wrapper
  runs the plain version on a CPU tensor;
* ``impl="jnp"`` — force ``torch_oracle``, which raises on a CUDA tensor.

Under an active mesh (:func:`repro_torch.launch.mesh.mesh_context`) a
packed product routes through the SPMD layer (:mod:`repro_torch.runtime.spmd`):
each rank runs the chosen kernel on its local problem, with the mesh
signature in the problem key.  ``spmd=None`` opts a call out (the layer's
own local calls are never wrapped again); ``REPRO_SPMD=0`` turns the routing
off for the process, as in the reference.

Dispatch runs on every call (PyTorch is eager, where the reference resolves
once per trace), so a resolution is memoized per problem and cache state;
nothing is ever measured here (``--autotune`` fills the cache).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.kernels import autotune, registry
from repro_torch.kernels import decompress as decompress_kernel

__all__ = ["sod_matmul", "decompress", "dense_matmul", "mm_f32", "resolve"]

_CUDA_IMPLS = {"tiled_csc": "cuda_fused", "block_csr": "cuda_block"}
_FORCED = {
    "cuda": _CUDA_IMPLS,
    "pallas": _CUDA_IMPLS,
    "jnp": {"tiled_csc": "torch_oracle", "block_csr": "torch_oracle"},
}
# (key, impl, params, bm, fallback, cache version) -> (impl, params, source);
# bounded by the handful of problems a model has
_RESOLVED: dict[tuple, tuple[registry.KernelImpl, dict, str]] = {}


# the device types whose 16-bit dense products take the card's path: the
# card's, and the dry-run's meta tensors, which count the card's program
_CARD_PATH = ("cuda", "meta")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands, or 3-D ones batched over their first dim,
    as the reference's ``jnp.dot`` / ``jnp.einsum(...,
    preferred_element_type=float32)``: the operands promoted to one dtype,
    products summed in float32, float32 out.  On CUDA with 16-bit operands
    one cuBLAS call keeps the f32 sums (``aten::mm.dtype``,
    ``aten::bmm.dtype``; never a 16-bit split-K reduction), and so on the
    dry-run's meta tensors; the CPU build has no such kernel, so there the
    operands are widened first, which gives the same sums of exact
    products.  Not differentiable: autograd goes through
    :func:`dense_matmul`."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    mm = torch.bmm if a.ndim == 3 else torch.mm
    if a.device.type in _CARD_PATH and dtype in (torch.bfloat16, torch.float16):
        if a.device.type == "meta" and a.ndim == 3:    # FlopCounterMode has no bmm.dtype
            return mm(a.to(dtype), b.to(dtype)).float()
        return mm(a.to(dtype), b.to(dtype), out_dtype=torch.float32)
    return mm(a.float(), b.float())


class _MmF32(torch.autograd.Function):
    """:func:`mm_f32` with the derivative that ``aten::mm.dtype`` lacks:
    ``ga = g @ bᵀ`` and ``gb = aᵀ g``, each with float32 sums and cast to
    its operand's dtype — how JAX transposes a dot with
    ``preferred_element_type=float32``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = mm_f32(g, b.mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = mm_f32(a.mT, g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def dense_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` for a dense 2-D ``w``, as the reference's ``jnp.dot(x, w,
    preferred_element_type=float32).astype(out_dtype)``: the operands
    promoted to one dtype (bf16 activations meet an f32 weight as f32),
    products summed in float32 (:func:`mm_f32`), the sums cast once to
    ``out_dtype``.  A 3-D ``w`` (E, K, N) takes x (E, M, K), one product a
    leading index (the MoE experts' ``ebcd,edf->ebcf``).  Differentiable:
    under autograd the cuBLAS call goes through :class:`_MmF32` (which
    keeps the 16-bit operands; on meta tensors too, so the dry-run counts
    the card's saved bytes); the CPU path's widening differentiates as it
    is."""
    x2 = x if w.ndim == 3 else x.reshape(-1, x.shape[-1])
    on_card = x.device.type in _CARD_PATH and torch.promote_types(
        x.dtype, w.dtype) in (torch.bfloat16, torch.float16)
    if on_card and torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _MmF32.apply(x2, w)
    else:
        y = mm_f32(x2, w)
    return y.to(out_dtype).reshape(*x.shape[:-1], w.shape[-1])


def _frozen(d: dict | None) -> tuple:
    # unsorted: one dict gives one order, and another order of the same
    # items only costs a second memo entry
    return tuple(d.items()) if d else ()


def _resolve(key: registry.ProblemKey, impl: str, params: dict | None,
             bm: int | None, fallback_params: dict | None
             ) -> tuple[registry.KernelImpl, dict, str]:
    if impl in _FORCED:
        chosen = registry.get_impl(_FORCED[impl][key.fmt])
        run_params, source, tuned = chosen.default_params(key), "forced", None
    elif impl == "auto":
        tuned = autotune.lookup(key)
        chosen, run_params = registry.choose(key, tuned=tuned, note=False)
        source = "tuned" if tuned is not None and tuned.get("impl") == chosen.name \
            else "prior"
    else:
        raise ValueError(f"unknown impl {impl!r}; want auto | cuda | jnp "
                         "(or pallas, the reference's name for cuda)")
    space = chosen.param_space(key)
    run_params = dict(run_params)
    if fallback_params and tuned is None:
        run_params.update((k, v) for k, v in fallback_params.items() if k in space)
    if params:
        run_params.update((k, v) for k, v in params.items() if k in space)
    if bm is not None and "bm" in space:
        run_params["bm"] = bm
    return chosen, run_params, source


def resolve(key: registry.ProblemKey, impl: str, params: dict | None = None,
            bm: int | None = None, fallback_params: dict | None = None,
            ) -> tuple[registry.KernelImpl, dict]:
    """(impl, run_params) for a problem key — the one dispatch resolver.

    ``params`` always override the tuned or default choice; ``fallback_params``
    (a pack plan's dispatch hint) only seed dispatch when the tuning cache
    has no entry for this (layout, M bucket): a hint recorded at one M never
    overrides a winner tuned at another.  Keys outside the chosen impl's
    param space are dropped (a reference plan's ``slot_chunk`` and
    ``k_slab``); its ``bm`` is a key of both spaces, and the CUDA impls map
    it onto their compiled M blocks.
    """
    memo = (key, impl, _frozen(params), bm, _frozen(fallback_params),
            autotune.get_cache().version)
    hit = _RESOLVED.get(memo)
    if hit is None:
        if len(_RESOLVED) > 4096:
            _RESOLVED.clear()
        hit = _RESOLVED[memo] = _resolve(key, impl, params, bm, fallback_params)
    chosen, run_params, source = hit
    registry.note_dispatch(key, chosen, run_params, source)
    return chosen, dict(run_params)


def sod_matmul(x: torch.Tensor, w, *, impl: str = "auto", bm: int | None = None,
               out_dtype: torch.dtype | None = None, backend: str | None = None,
               params: dict | None = None,
               fallback_params: dict | None = None,
               spmd: object = "auto") -> torch.Tensor:
    """``x @ W`` where ``W`` is dense, :class:`TiledCSC` or :class:`BlockCSR`.

    ``x``: (..., K).  Returns (..., N) in ``out_dtype`` (default: x.dtype).
    ``params`` overrides individual tunables (e.g. ``{"bm": 8}``) on top of
    the tuned or default choice; ``backend`` overrides the backend taken
    from x's device (``cuda`` / ``cpu``).  A packed W whose values have
    another dtype than x is computed in the promoted dtype (``_promote``).

    ``spmd``: ``"auto"`` routes a packed product through the SPMD layer
    when a mesh is active (inside a partitioned step,
    :func:`repro_torch.runtime.spmd.use_partition`, its local contract
    under the plan of the weight's resident block); an explicit
    :class:`repro_torch.runtime.spmd.SpmdPlan` forces a partitioning; None
    runs the product whole on this process.
    """
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, (TiledCSC, BlockCSR)):
        return dense_matmul(x, w, out_dtype)
    k, n = w.global_shape
    x, w = _promote(x, w)
    if spmd is not None and os.environ.get("REPRO_SPMD", "1") != "0":
        from repro_torch.runtime import spmd as spmd_mod  # deferred: runtime over kernels

        part = spmd_mod.active_partition()
        if part is not None and not spmd_mod.in_spmd_body():
            # the partitioned program: the local contract, the weight as it lies
            return spmd_mod.sod_matmul_local(
                x, w, part, impl=impl, bm=bm, out_dtype=out_dtype, backend=backend,
                params=params, fallback_params=fallback_params)
    if x.shape[-1] != k:
        raise ValueError(f"x inner dim {x.shape[-1]} != W K {k}")
    if spmd is not None and os.environ.get("REPRO_SPMD", "1") != "0":
        from repro_torch.runtime import spmd as spmd_mod  # deferred: runtime over kernels

        if not spmd_mod.in_spmd_body():
            plan = spmd if isinstance(spmd, spmd_mod.SpmdPlan) else None
            mesh = spmd_mod.active_mesh()
            if plan is None and spmd == "auto" and mesh is not None:
                plan = spmd_mod.auto_plan(mesh, w)
            if plan is not None:
                return spmd_mod.sod_matmul_spmd(
                    x, w, mesh=mesh, plan=plan, impl=impl, bm=bm,
                    out_dtype=out_dtype, backend=backend, params=params,
                    fallback_params=fallback_params)
    if w.shard is not None:
        raise ValueError("a resident block of a packed operand multiplies only "
                         "under a mesh (repro_torch.launch.mesh.mesh_context)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    key = registry.problem_key(w, m=x2.shape[0],
                               backend=backend or registry.current_backend(x.device))
    chosen, run_params = resolve(key, impl, params=params, bm=bm,
                                 fallback_params=fallback_params)
    y = chosen.run(x2, w, out_dtype=out_dtype, **run_params)
    return y.reshape(*lead, n)


def _promote(x: torch.Tensor, w):
    """x and a packed qmode-``none`` w whose value dtype differs from x's,
    both in their promoted dtype, as the reference's ``jnp.dot`` promotes
    them (bf16 meets f32 as f32; both widenings are exact).  The kernels
    take one dtype, so the values are widened in a copy, once per call: no
    serving path mixes dtypes.  Quantized codes are left to the kernel
    wrapper, which checks them."""
    if w.qmode != "none" or w.dtype == x.dtype:
        return x, w
    dtype = torch.promote_types(x.dtype, w.dtype)
    field = "vals" if isinstance(w, TiledCSC) else "block_vals"
    return x.to(dtype), dataclasses.replace(w, **{field: getattr(w, field).to(dtype)})


def decompress(w) -> torch.Tensor:
    """Dense matrix of a packed operand at its logical shape: a ``TiledCSC``
    through the decompression kernel, a ``BlockCSR`` through its scatter,
    each in its value dtype, or float32 when quantized (as the reference);
    a dense tensor comes back unchanged."""
    if isinstance(w, TiledCSC):
        return decompress_kernel.decompress(w)
    if isinstance(w, BlockCSR):
        return w.to_dense()
    return w
