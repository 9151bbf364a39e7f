"""Mixture-of-Experts MLP with top-k routing and a shared expert.

Twin of :mod:`repro.models.moe`, which covers the two MoE configs: granite-moe-1b-a400m (32 routed experts, top-8) and
qwen2-moe-a2.7b (60 routed experts padded to 64, top-4, and a shared
expert behind a sigmoid gate).  Dispatch is the reference's capacity
buffer: each token's k assignments are ranked first-come within their
expert (a stable sort), scattered into an (E, blocks, capacity, d) buffer,
run through three batched expert products and gathered back, weighted by
the normalised gate values.  Assignments past an expert's capacity are
dropped (their weight is 0).

The router, the shared gate and the expert products are dense products
outside any Sparse-on-Dense kernel, as in the reference; they keep its
float32 sums (:func:`repro_torch.kernels.ops.dense_matmul`).  The shared expert's MLP runs
through ``sod.apply`` like any MLP.

Under an active mesh (:mod:`repro_torch.launch.mesh`) that has the
``a2a_axis`` (expert parallelism, EP), the routed experts run as the
reference's ``_a2a_dispatch``: the tokens split over (data axes × EP), each
rank ranks its own block into a capacity buffer, an all-to-all over the EP
line hands every rank the tokens of its ``E / ep`` experts, and the reverse
all-to-all brings the results back (:func:`_a2a_dispatch`).  The result
equals the capacity dispatch with ``dispatch_blocks`` = the number of
token shards.  Where the reference falls back (no mesh, the EP axis among
the data axes, experts or the global batch's tokens that do not divide)
the port takes the capacity dispatch too.

In a partitioned step (:func:`repro_torch.runtime.spmd.use_partition`)
the block runs on the rank's rows: the router and the shared gate whole,
the shared expert the partitioned MLP, the aux loss's means the global
batch's.  The capacity and the dispatch blocks follow the global token
count, as the reference's, and every assignment's first-come slot is its
place in its block across the whole batch (:func:`first_come_slots`; an
all-gather of per-block histograms where a block spans ranks), so a rank
keeps and drops what one process does; it runs only its ``E / tp``
experts on its own rows' kept assignments, the partial outputs summed
over ``model`` (:func:`_partitioned_dispatch`).  The all-to-all splits
the rank's rows further over EP.  The reference's sharding constraints
only guide GSPMD and have no counterpart.  Packed routed experts are refused
(:func:`moe_mlp`): the reference's batched einsum cannot take a packed
operand either.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.plan import ModelPlan
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.runtime import spmd

Params = dict[str, Any]

ROUTED = ("w_gate", "w_up", "w_down")
# plan paths of the routed experts' stacks
ROUTED_PATHS = tuple(f".blocks.moe.{n}" for n in ROUTED)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Routing and expert shapes of one MoE layer (the reference's fields)."""

    n_experts: int          # real experts
    n_experts_padded: int   # ceil-padded to the EP axis; the router masks padding
    top_k: int
    d_model: int
    d_ff: int               # per-expert hidden
    n_shared: int = 0       # shared experts (always on)
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    act: str = "silu"
    dispatch_blocks: int = 1    # rank and dispatch within this many token blocks
    a2a_axis: str | None = None  # mesh axis of the all-to-all exchange (EP); None: capacity dispatch

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert has for ``n_tokens`` tokens: ``n · k / E ·
        capacity_factor``, rounded up to a multiple of 128, at least 128."""
        c = int(n_tokens * self.top_k / max(self.n_experts, 1)
                * self.capacity_factor)
        return max((c + 127) // 128 * 128, 128)


def pad_experts(n_experts: int, ep_axis: int = 16) -> int:
    """``n_experts`` rounded up to a multiple of ``ep_axis``."""
    return (n_experts + ep_axis - 1) // ep_axis * ep_axis


def init_moe(gen: torch.Generator, spec: MoESpec, dtype: torch.dtype,
             device: torch.device) -> Params:
    """Router (d, E) float32, the routed experts' stacks ``w_gate``/``w_up``
    (E, d, f) and ``w_down`` (E, f, d) at N(0, 1/d_in), and with
    ``spec.n_shared`` the shared MLP and its gate (d, 1) float32."""
    e, d, f = spec.n_experts_padded, spec.d_model, spec.d_ff

    def expert_init(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / d_in) ** 0.5).to(dtype)

    params: Params = {
        "router": layers.dense_init(gen, d, e, torch.float32, device),
        "w_gate": expert_init(d, f),
        "w_up": expert_init(d, f),
        "w_down": expert_init(f, d),
    }
    if spec.n_shared:
        params["shared"] = layers.init_mlp(
            gen, d, spec.d_shared_ff or spec.d_ff * spec.n_shared, dtype, device)
        params["shared_gate"] = layers.dense_init(gen, d, 1, torch.float32, device)
    return params


def _rank_in_expert(assign: torch.Tensor, e: int) -> torch.Tensor:
    """First-come slot rank of each assignment within its expert, for every
    row of ``assign`` (..., A) apart: a stable sort by expert, then each
    assignment's place after its expert's start.  The reference's
    ``_rank_in_expert`` on one row, batched over the leading dims."""
    lead, a = assign.shape[:-1], assign.shape[-1]
    flat = assign.reshape(-1, a)
    order = torch.sort(flat, dim=-1, stable=True).indices
    sorted_e = torch.gather(flat, 1, order)
    hist = torch.zeros((flat.shape[0], e), dtype=torch.long, device=assign.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(hist, 1) - hist
    rank = torch.arange(a, device=assign.device) - torch.gather(starts, 1, sorted_e)
    return torch.empty_like(flat).scatter_(1, order, rank).reshape(*lead, a)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, equal values in
    index order (a stable descending sort; ``torch.topk`` promises no order
    among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def without_routed(plan: ModelPlan) -> ModelPlan:
    """``plan`` with the routed experts' entries dropped, so replaying it
    keeps them dense (unplanned leaves stay as they are) while attention,
    the shared expert and the head pack as planned: the way to serve MoE
    through the Sparse-on-Dense kernels (fault R4)."""
    return ModelPlan({p: e for p, e in plan.entries.items() if p not in ROUTED_PATHS},
                     mesh=plan.mesh, meta=plan.meta)


def router_logits(params: Params, xt: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Router logits (T, E) in float32: ``xt @ router`` with the router in
    xt's dtype and float32 sums, the padded experts at -1e30."""
    logits = ops.dense_matmul(xt, params["router"].to(xt.dtype), torch.float32)
    if spec.n_experts_padded > spec.n_experts:
        pad = torch.arange(spec.n_experts_padded, device=xt.device) >= spec.n_experts
        logits = torch.where(pad, -1e30, logits)
    return logits


def shared_gate(params: Params, xt: torch.Tensor) -> torch.Tensor:
    """The shared expert's gate (T, 1) in xt's dtype: the sigmoid of ``xt @
    shared_gate``, the product rounded to xt's dtype first (the reference's
    dot has no float32 preference here)."""
    return torch.sigmoid(ops.dense_matmul(xt, params["shared_gate"].to(xt.dtype),
                                          xt.dtype))


def _check_dense_experts(params: Params) -> None:
    packed = [n for n in ROUTED if isinstance(params[n], (TiledCSC, BlockCSR))]
    if packed:
        raise ValueError(
            f"packed routed experts {packed} (fault R4, kept from the reference: "
            "its batched expert einsum takes no packed operand, and neither does "
            "the port); serve MoE under a pack plan without routed-expert "
            "entries (.blocks.moe.w_gate / w_up / w_down; moe.without_routed), "
            "which keeps them dense")


def _row_range(part) -> tuple[int, int]:
    """``(ranks the rows split over, this rank's place among them)`` in the
    partitioned program ``part`` (1 and 0 where every rank holds every
    row, or outside one)."""
    if part is None or not part.rows:
        return 1, 0
    return spmd._axes_size(part.mesh, part.rows), part.mesh.index(part.rows)


def _assignment_blocks(expert_ids: torch.Tensor, r0: int, tb: int) -> torch.Tensor:
    """(t·k,): the global dispatch block (``tb`` tokens each) of every
    assignment of the tokens [r0, r0 + t) of the flattened batch (their
    expert ids (t, k))."""
    t, k = expert_ids.shape
    tokens = torch.arange(r0, r0 + t, device=expert_ids.device)
    return torch.div(tokens, tb, rounding_mode="floor").repeat_interleave(k)


def block_hist(expert_ids: torch.Tensor, e: int, r0: int, tb: int, nb: int) -> torch.Tensor:
    """(nb, e) counts of the assignments of the tokens [r0, r0 + t) (their
    expert ids (t, k)) in each global dispatch block of ``tb`` tokens and
    each expert: what a rank tells the ranks after it."""
    key = _assignment_blocks(expert_ids, r0, tb) * e + expert_ids.reshape(-1)
    hist = torch.zeros(nb * e, dtype=torch.long, device=expert_ids.device)
    return hist.scatter_add_(0, key, torch.ones_like(key)).reshape(nb, e)


def first_come_slots(expert_ids: torch.Tensor, e: int, r0: int, tb: int,
                     before: torch.Tensor | None = None):
    """``(block, slot)`` of every assignment of the tokens [r0, r0 + t) of
    the flattened batch (expert ids (t, k), flattened (t·k,)): its global
    dispatch block of ``tb`` tokens, and its first-come slot within its
    expert and block across the whole batch, which is its rank among this
    range's assignments (token, then k order, as the reference's
    ``_rank_in_expert`` of a block) plus ``before[block, expert]``, the
    count of the same expert among the earlier tokens of the block (None:
    there are none, every block this range touches starts inside it)."""
    t = expert_ids.shape[0]
    blocks = _assignment_blocks(expert_ids, r0, tb)
    b0 = r0 // tb
    nb_l = (r0 + t - 1) // tb - b0 + 1
    flat_e = expert_ids.reshape(-1)
    slot = _rank_in_expert(((blocks - b0) * e + flat_e)[None], nb_l * e)[0]
    if before is not None:
        slot = slot + before[blocks, flat_e]
    return blocks, slot


def _expert_mlp(buf: torch.Tensor, w, act: str) -> torch.Tensor:
    """The experts' SwiGLU on their slots: ``buf`` (E, slots, D) through the
    (E, D, F) / (E, F, D) stacks ``w["w_gate"]``, ``w["w_up"]``,
    ``w["w_down"]``, float32 sums rounded to buf's dtype."""
    h_gate = ops.dense_matmul(buf, w["w_gate"], buf.dtype)
    h_up = ops.dense_matmul(buf, w["w_up"], buf.dtype)
    return ops.dense_matmul(layers.activate(h_gate, act) * h_up, w["w_down"], buf.dtype)


def _a2a_dispatch(params: Params, xt: torch.Tensor, gate_vals: torch.Tensor,
                  expert_ids: torch.Tensor, spec: MoESpec):
    """The routed experts' output (T, D) through the all-to-all token
    exchange over ``spec.a2a_axis``, or None where the reference's
    ``_a2a_dispatch`` returns None: no active mesh or no such axis in it,
    inside an SPMD body, the EP axis among the data axes, or experts or
    the global batch's tokens that do not divide (data axes × EP).

    The tokens split over (data axes × EP), row-major, as the reference's
    ``shard_map`` splits them.  ``xt`` holds the rank's rows: the global
    batch on every rank (the whole-rows layout, or a partitioned step
    whose rows do not divide the data axes: the rank takes its token block
    by its (data…, EP) position), or in a partitioned step its rows over
    the data axes (it takes its block of them over EP).  It ranks the
    block's assignments first-come into an (E, cap, D) buffer and
    exchanges it over the EP line (:func:`repro_torch.runtime.spmd.
    exchange`): it receives, for each of its ``E / ep`` experts, every EP
    peer's buffer.  Its experts run as the capacity dispatch runs them
    (float32 sums), the reverse exchange returns the results, and the
    blocks are gathered back into ``xt``'s rows.  Outside a partitioned
    step the expert leaves are whole on every rank and the rank slices its
    own (their gradients summed over the data axes and gathered over EP);
    inside one they are the rank's placed ``E / ep`` block, whose
    gradients are summed over the data axes its rows do not split
    (:func:`~repro_torch.runtime.spmd.grad_sum`; the step sums the rest).
    The exchange's backward is the reverse exchange."""
    mesh = spmd.active_mesh()
    ep_ax = spec.a2a_axis
    if mesh is None or ep_ax not in mesh.axis_names or spmd.in_spmd_body():
        return None
    part = spmd.active_partition()
    t, d = xt.shape
    e, k = spec.n_experts_padded, spec.top_k
    ep = mesh.shape[ep_ax]
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if ep_ax in dp:
        return None                      # EP must be distinct from the data axes
    rows = part.rows if part is not None else ()
    n_tok_shards = ep * spmd._axes_size(mesh, dp)
    t_all = t * _row_range(part)[0]
    if e % ep or t_all % n_tok_shards:
        return None                      # shapes do not divide: capacity dispatch
    t_l, e_per = t_all // n_tok_shards, e // ep
    cap = spec.capacity(t_l)
    tok_axes = tuple(a for a in dp if a not in rows) + (ep_ax,)

    xt_l = spmd.shard_rows(xt, mesh, tok_axes)
    gate_l = spmd.shard_rows(gate_vals, mesh, tok_axes)
    assign = spmd.shard_rows(expert_ids, mesh, tok_axes).reshape(-1)    # (t_l·K,)
    if part is None:
        w = {n: spmd.shard_rows(params[n], mesh, ep_ax, sum_axes=dp) for n in ROUTED}
    else:
        w = {n: spmd.grad_sum(params[n], mesh, tuple(a for a in dp if a not in rows))
             for n in ROUTED}
    slot = _rank_in_expert(assign, e)
    keep = slot < cap
    src = xt_l[:, None, :].expand(t_l, k, d).reshape(-1, d)
    # kept (expert, slot) pairs are unique: a store equals the reference's add
    buf = torch.index_put(xt_l.new_zeros((e, cap + 1, d)),
                          (assign, torch.where(keep, slot, cap)), src)[:, :cap]
    # block j of the E dim (peer j's experts) goes to peer j; what comes back
    # is, for this rank's experts, every peer's buffer in peer order
    recv = spmd.exchange(buf, mesh, ep_ax).reshape(ep, e_per, cap, d)
    recv = recv.transpose(0, 1).reshape(e_per, ep * cap, d)
    out_e = _expert_mlp(recv, w, spec.act)                             # (E/ep, ep·C, D)
    out_e = out_e.reshape(e_per, ep, cap, d).transpose(0, 1).reshape(e, cap, d)
    back = spmd.exchange(out_e, mesh, ep_ax)                           # (E, C, D)
    gathered = back[assign, slot.clamp(0, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    weights = (gate_l.reshape(-1) * keep).to(xt.dtype)
    y_l = (gathered * weights[:, None]).reshape(t_l, k, d).sum(1)
    return spmd.gather_rows(y_l, mesh, tok_axes)


def moe_mlp(params: Params, x: torch.Tensor, spec: MoESpec, plans=None):
    """x (B, S, D) → (y (B, S, D), router aux loss (float32 scalar)).

    ``plans`` maps the shared expert's projection names to their
    :class:`repro_torch.core.plan.PackPlan`.  The routed experts must be
    dense: a packed one raises ``ValueError`` (fault R4).  With
    ``spec.a2a_axis`` under a mesh that has it, they run through
    :func:`_a2a_dispatch`; else through the capacity dispatch
    (:func:`_partitioned_dispatch` in a partitioned step).  In a
    partitioned step ``x`` is the rank's rows: the router and the shared
    gate are whole, the shared expert is the partitioned MLP, and the aux
    loss's means are the global batch's.
    """
    _check_dense_experts(params)
    b, s, d = x.shape
    t, k = b * s, spec.top_k
    e = spec.n_experts_padded
    xt = x.reshape(t, d)
    part = spmd.active_partition()

    probs = torch.softmax(router_logits(params, xt, spec), dim=-1)   # (T, E) f32
    gate_vals, expert_ids = _top_k(probs, k)                  # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    combined = None
    if spec.a2a_axis is not None:
        combined = _a2a_dispatch(params, xt, gate_vals, expert_ids, spec)
    if combined is None:
        dispatch = _capacity_dispatch if part is None else _partitioned_dispatch
        combined = dispatch(params, xt, gate_vals, expert_ids, spec)

    if "shared" in params:
        combined = combined + shared_gate(params, xt) * layers.mlp(
            params["shared"], xt, spec.act, plans=plans,
            d_ff=spec.d_shared_ff or spec.d_ff * spec.n_shared)

    # Switch-style load-balance loss; the reference's unused ``ce`` is skipped.
    # The counts are a scatter-add (bincount's, shape-static on meta tensors);
    # in a partitioned step both means are the global batch's
    ids = expert_ids.reshape(-1)
    counts = torch.zeros(e, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids)).float()
    n_rows = _row_range(part)[0]
    if n_rows > 1:
        me = spmd.psum(probs.sum(0), part.mesh, part.rows) / (t * n_rows)
        counts = spmd.all_reduce(counts, part.mesh, part.rows)
    else:
        me = probs.mean(0)
    frac = counts / (t * n_rows * k)
    aux = spec.router_aux_weight * (frac * me).sum() * e
    return combined.reshape(b, s, d), aux


def _capacity_dispatch(params: Params, xt: torch.Tensor, gate_vals: torch.Tensor,
                       expert_ids: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """The routed experts' output (T, D) through the reference's capacity
    buffer, ranked within ``spec.dispatch_blocks`` contiguous token blocks
    (one block when they do not divide T)."""
    t, d = xt.shape
    e, k = spec.n_experts_padded, spec.top_k
    nb = spec.dispatch_blocks if t % spec.dispatch_blocks == 0 else 1
    tb = t // nb
    cap = spec.capacity(tb)
    slot = _rank_in_expert(expert_ids.reshape(nb, tb * k), e).reshape(t, k)
    keep = slot < cap
    flat_e = expert_ids.reshape(-1)
    flat_b = torch.arange(nb, device=xt.device).repeat_interleave(tb * k)
    flat_slot = torch.where(keep, slot, cap).reshape(-1)      # cap: the drop bin
    src = xt[:, None, :].expand(t, k, d).reshape(-1, d)
    # every kept (e, b, slot) is unique, so a store equals the reference's add
    # into zeros; only the drop bin, sliced away, takes more than one row
    dispatched = torch.index_put(xt.new_zeros((e, nb, cap + 1, d)),
                                 (flat_e, flat_b, flat_slot), src)
    dispatched = dispatched[:, :, :cap].reshape(e, nb * cap, d)
    out_e = _expert_mlp(dispatched, params, spec.act).reshape(e, nb, cap, d)

    gathered = out_e[flat_e, flat_b, flat_slot.clamp(0, cap - 1)]
    gathered = torch.where(keep.reshape(-1, 1), gathered, 0)
    weights = (gate_vals * keep).reshape(-1, 1).to(xt.dtype)
    return (gathered * weights).reshape(t, k, d).sum(1)


def _partitioned_dispatch(params: Params, xt: torch.Tensor, gate_vals: torch.Tensor,
                          expert_ids: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """The capacity dispatch of a partitioned step: ``xt`` (T_l, D) is the
    rank's rows, a contiguous range [r0, r0 + T_l) of the flattened global
    batch of T tokens.

    The blocks and the capacity are the global batch's, by the reference's
    rule (``dispatch_blocks`` where it divides T, else 1; ``capacity(T /
    nb)``), and so is every assignment's first-come slot
    (:func:`first_come_slots`): where a block spans several ranks' rows
    (``nb`` not a multiple of the row ranks), the ranks all-gather over the
    data axes one (nb, E) histogram each (:func:`block_hist`) and each adds
    the earlier ranks' counts.  An assignment is kept iff its slot is below
    the capacity, as in one process.  The rank runs only the experts it
    holds (the placed ``E / tp`` block, or every expert where they do not
    divide ``model``) on its own rows' kept assignments: its buffer holds,
    for each block its rows touch, at most as many slots as it has tokens
    there.  The partial outputs are summed over ``model`` in float32 (the
    activations and gates into them through
    :func:`~repro_torch.runtime.spmd.grad_sum`, as a column-parallel
    product's)."""
    part = spmd.active_partition()
    mesh = part.mesh
    t, d = xt.shape
    e, k = spec.n_experts_padded, spec.top_k
    n_rows, row = _row_range(part)
    t_all, r0 = t * n_rows, row * t
    nb = spec.dispatch_blocks if t_all % spec.dispatch_blocks == 0 else 1
    tb = t_all // nb
    cap = spec.capacity(tb)
    before = None
    if n_rows > 1 and nb % n_rows:
        hists = spmd.all_gather(block_hist(expert_ids, e, r0, tb, nb)[None], mesh, part.rows,
                                0, "route_bytes")
        before = hists[:row].sum(0)
    blocks, slot = first_come_slots(expert_ids, e, r0, tb, before)
    b0 = r0 // tb
    nb_l = (r0 + t - 1) // tb - b0 + 1
    lb = blocks - b0
    e_l = params["w_gate"].shape[0]
    split = e_l != e
    flat_e = expert_ids.reshape(-1)
    e0 = part.part * e_l if split else 0
    mine = (slot < cap) & (flat_e >= e0) & (flat_e < e0 + e_l)
    # a kept assignment's slot less the earlier ranks' counts is its rank
    # among this rank's assignments of its (block, expert): below its tokens
    # in the block
    local = slot - (before[blocks, flat_e] if before is not None else 0)
    cap_l = min(cap, tb, t)
    flat_slot = torch.where(mine, local, cap_l)               # cap_l: the drop bin
    flat_x = torch.where(mine, flat_e - e0, 0)
    if split:
        xt = spmd.grad_sum(xt, mesh, "model")
        gate_vals = spmd.grad_sum(gate_vals, mesh, "model")
    src = xt[:, None, :].expand(t, k, d).reshape(-1, d)
    dispatched = torch.index_put(xt.new_zeros((e_l, nb_l, cap_l + 1, d)),
                                 (flat_x, lb, flat_slot), src)
    dispatched = dispatched[:, :, :cap_l].reshape(e_l, nb_l * cap_l, d)
    out_e = _expert_mlp(dispatched, params, spec.act).reshape(e_l, nb_l, cap_l, d)

    gathered = out_e[flat_x, lb, flat_slot.clamp(0, cap_l - 1)]
    gathered = torch.where(mine[:, None], gathered, 0)
    weights = (gate_vals.reshape(-1) * mine).reshape(-1, 1).to(xt.dtype)
    y = (gathered * weights).reshape(t, k, d)
    if not split:
        return y.sum(1)
    return spmd.psum(y.float().sum(1), mesh, "model").to(xt.dtype)
