"""SPMD execution layer: packed matmuls over a mesh of ranks.

Twin of :mod:`repro.runtime.spmd`.  The reference wraps a kernel in
``shard_map`` under a partition *plan*; the port runs the same plan over a
process group (:class:`repro_torch.launch.mesh.Mesh`), one rank per mesh
position, each launching the registry's kernel on its own local problem:

* **data-parallel M-sharding** (``batch_axes``) — the flattened rows split
  over the data axes;
* **column tensor parallelism** (``col_axis``) — the packed operand's Nt
  tile-grid dim split; each rank computes its N-slice;
* **row tensor parallelism** (``row_axis``) — Kt split, ``x`` split along
  K, the partial products summed (``all_reduce``);
* **compressed all-gather / SoD-FSDP** (``gather_axis``) — the operand's
  Nt blocks are all-gathered *compressed* (values and row indices, or block
  values, ids and counts, and the per-tile scale; the codebook is
  replicated) and the rank re-densifies only inside its kernel.

Contract of :func:`sod_matmul_spmd`: the *global* ``x`` on every rank in,
the *global* ``y`` on every rank out (rows and columns all-gathered), as
the reference's function returns a global array.  Its *local* contract
(``local=True``, what a ``shard_map`` inside a sharded program takes and
returns) keeps what is split split: the rank's rows in and out, the
column block of a column plan out, the K block of ``x`` into a row plan
(the partial products all-reduced over its axis), nothing gathered; a
grid dim split with a padded tail is read whole, as the global contract
reads it.  The operand is either
whole on every rank or a rank's resident block (``w.shard``, from
:func:`repro_torch.runtime.sharding.place`); where the plan reads another
block than the resident one, the rank all-gathers the compressed resident
blocks and slices its own — the resharding GSPMD inserts at a
``shard_map`` boundary.  Nothing dense crosses the wire, and every
collective's bytes are counted (:func:`count_collectives`).

Dispatch inside a rank is the ordinary registry resolution with the mesh
signature in the :class:`~repro_torch.kernels.registry.ProblemKey`
(``data=4,model=2|dp=data;col=model``), so tuned entries are per local
shard.  Gradients: a ``torch.autograd.Function`` whose backward is
``shard_map``'s transpose — each rank takes its block of the (replicated)
output cotangent, runs the local kernel's own backward, sums weight
gradients over the batch axes and activation gradients over the column
axis, and gathers what it must; padding slots keep exactly-zero gradients.

Collectives are ``all_gather``, ``all_reduce`` and ``all_to_all`` (MoE's
token exchange, :mod:`repro_torch.models.moe`).  Every tensor crosses as
bytes in ``all_gather`` and ``all_to_all`` (fp8 codes included); sums go
through float32.  :func:`shard_rows` and :func:`gather_rows` take a rank's
block of a replicated tensor and put the blocks back together, each the
other's transpose under autograd.

The partitioned program (:class:`Partition`, :func:`use_partition`): a
step of every family runs every op on the rank's rows and on its share
of heads (:func:`model_block`), MLP columns, routed experts, vocabulary
and codebook columns, as GSPMD partitions the reference's jitted step; a
decode step whose KV cache splits its sequence over ``model`` (the
reference's ``cache_specs``) attends on the rank's block of positions
(:func:`seq_block`), the softmax's max (:func:`pmax`) and sums
(:func:`all_reduce`) taken over ``model``.
Packed products then take the local contract under the plan of their
resident block (:func:`sod_matmul_local`), and
plain ops move between whole and split layouts with four differentiable
collectives, each the other's transpose in pairs: :func:`psum` (a sum of
partials; the cotangent flows back whole) and :func:`grad_sum` (the
identity; the cotangent's partials summed), :func:`take_block` (a block
of a replicated tensor; the scattered cotangents summed) and
:func:`gather_rows` (the blocks put together; the cotangent's own block).

On a counting mesh (:class:`repro_torch.launch.mesh.DryMesh`, the
dry-run's) nothing launches and nothing crosses: each collective counts the
bytes it would move and returns a ``meta`` tensor of the shape a group
gives, and a packed product resolves the kernel of the mesh's backend (the
card's) and computes only its shape (:func:`_shape_product`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import zlib

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.formats import BlockCSR, TiledCSC
from repro_torch.core.tree import PACKED_FIELDS
from repro_torch.kernels import registry

__all__ = [
    "SpmdPlan",
    "active_mesh",
    "use_mesh",
    "in_spmd_body",
    "mesh_key",
    "auto_plan",
    "plan_from_spec",
    "packed_specs",
    "sod_matmul_spmd",
    "sod_matmul_local",
    "local_plan",
    "local_split",
    "Partition",
    "use_partition",
    "active_partition",
    "model_block",
    "seq_block",
    "psum",
    "pmax",
    "grad_sum",
    "take_block",
    "warmup_params_spmd",
    "count_collectives",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "exchange",
    "shard_rows",
    "gather_rows",
]

_IN_BODY = contextvars.ContextVar("repro_torch_spmd_in_body", default=False)
# the active meshes, innermost last: process-wide (a rank is a process), so
# autograd's device threads, which replay checkpointed blocks in a CUDA
# backward, route through the mesh too
_MESHES: list = []
_PARTITIONS: list = []
_COUNTS: list[dict] = []


def in_spmd_body() -> bool:
    """True while a rank runs the local kernel of one of this module's
    products — the guard :func:`repro_torch.kernels.ops.sod_matmul` uses
    so a body never wraps itself again."""
    return _IN_BODY.get()


def active_mesh():
    """The mesh of the innermost open :func:`use_mesh` block, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Route the packed matmuls of the block through ``mesh``."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        for i in range(len(_MESHES) - 1, -1, -1):
            if _MESHES[i] is mesh:
                del _MESHES[i]
                break


def mesh_key(mesh) -> str:
    """Stable signature of a mesh's (axis, size) layout: ``data=4,model=2``."""
    return ",".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)


@contextlib.contextmanager
def count_collectives(counts: dict | None = None):
    """Count the bytes this rank's collectives move while the context is
    active: ``gather_bytes`` (a gather plan's compressed operand blocks,
    received), ``reshard_bytes`` (compressed resident blocks gathered where
    a plan reads another block), ``output_bytes`` (the gathers of ``y`` and
    of the activation gradient, received), ``reduce_bytes`` (buffers summed
    by ``all_reduce``), ``grad_bytes`` (the weight gradients' gathers and
    sums), ``a2a_bytes`` (MoE's exchanged capacity buffers, received from
    the other ranks), ``route_bytes`` (the per-block expert histograms a
    partitioned MoE dispatch gathers), and ``calls``.

    Beside them, per collective in the reference dry-run's kinds
    (``repro.launch.dryrun.collective_bytes``): ``all-gather`` (the
    gathered result's bytes), ``all-reduce`` (twice the summed buffer's:
    a ring's reduce-scatter and all-gather) and ``all-to-all`` (the
    exchanged buffer's), and under ``counts`` the number of calls of each,
    keyed by the same kinds."""
    counts = {} if counts is None else counts
    _COUNTS.append(counts)
    try:
        yield counts
    finally:
        for i, entry in enumerate(_COUNTS):
            if entry is counts:
                del _COUNTS[i]
                break


def _note(kind: str, nbytes: int, op: str, op_bytes: int) -> None:
    for counts in _COUNTS:
        counts[kind] = counts.get(kind, 0) + int(nbytes)
        counts["calls"] = counts.get("calls", 0) + 1
        counts[op] = counts.get(op, 0) + int(op_bytes)
        calls = counts.setdefault("counts", {})
        calls[op] = calls.get(op, 0) + 1


@dataclasses.dataclass(frozen=True)
class SpmdPlan:
    """How one packed matmul is partitioned over the mesh.

    ``col_axis``, ``row_axis`` and ``gather_axis`` are mutually exclusive
    weight shardings (Nt-local, Kt-local, Nt-gathered); ``batch_axes`` may
    combine with any of them.
    """

    batch_axes: tuple[str, ...] = ()
    col_axis: str | None = None
    row_axis: str | None = None
    gather_axis: str | None = None

    def __post_init__(self):
        w_axes = [a for a in (self.col_axis, self.row_axis, self.gather_axis)
                  if a is not None]
        if len(w_axes) > 1:
            raise ValueError(f"plan shards the weight twice: {self}")
        if set(w_axes) & set(self.batch_axes):
            raise ValueError(f"axis both batch and weight sharded: {self}")

    def signature(self) -> str:
        """``dp=data;col=model``-style key part (``replicated`` if empty)."""
        parts = []
        if self.batch_axes:
            parts.append("dp=" + "+".join(self.batch_axes))
        if self.col_axis:
            parts.append(f"col={self.col_axis}")
        if self.row_axis:
            parts.append(f"row={self.row_axis}")
        if self.gather_axis:
            parts.append(f"gather={self.gather_axis}")
        return ";".join(parts) or "replicated"

    def axes(self) -> tuple[str, ...]:
        """Every axis the plan names."""
        return self.batch_axes + tuple(
            a for a in (self.col_axis, self.row_axis, self.gather_axis)
            if a is not None)

    @classmethod
    def from_dict(cls, d: dict) -> "SpmdPlan":
        """Rebuild from the serialized form a
        :class:`repro_torch.core.plan.PackPlan` carries."""
        return cls(
            batch_axes=tuple(d.get("batch_axes", ())),
            col_axis=d.get("col_axis"),
            row_axis=d.get("row_axis"),
            gather_axis=d.get("gather_axis"))


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _grid(w) -> tuple[int, int]:
    return tuple(int(g) for g in w.global_grid)


def auto_plan(mesh, w, m: int | None = None) -> SpmdPlan | None:
    """Default plan for a packed matmul on ``mesh``, or None when wrapping
    does not apply (one position, stacked layouts): rows over the data
    axes, and the Nt grid dim over ``model`` where it divides — how
    :mod:`repro_torch.runtime.sharding` lays projection weights out."""
    if not isinstance(w, (TiledCSC, BlockCSR)) or w.lead:
        return None
    if _axes_size(mesh, mesh.axis_names) <= 1:
        return None
    batch = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if not batch:
        batch = tuple(a for a in mesh.axis_names if a != "model")
    col = None
    if "model" in mesh.axis_names:
        _, nt = _grid(w)
        if mesh.shape["model"] > 1 and nt % mesh.shape["model"] == 0:
            col = "model"
    if not batch and col is None:
        return None
    return SpmdPlan(batch_axes=batch, col_axis=col)


def plan_from_spec(vals_spec, mesh, grid_dims: tuple[int, int] = (0, 1)) -> SpmdPlan:
    """Plan matching a packed leaf's resident spec (the spec tuple
    :func:`repro_torch.runtime.sharding.param_specs` gives its ``vals``): a
    sharded Kt grid dim becomes row parallelism, a sharded Nt dim column
    parallelism, and rows ride the data axes either way."""
    spec = tuple(vals_spec)
    kt_dim, nt_dim = grid_dims
    kt_ax = spec[kt_dim] if kt_dim < len(spec) else None
    nt_ax = spec[nt_dim] if nt_dim < len(spec) else None
    if isinstance(kt_ax, tuple):
        kt_ax = kt_ax[0] if kt_ax else None
    if isinstance(nt_ax, tuple):
        nt_ax = nt_ax[0] if nt_ax else None
    batch = tuple(a for a in mesh.axis_names
                  if a in ("pod", "data") and a not in (kt_ax, nt_ax))
    return SpmdPlan(batch_axes=batch, col_axis=nt_ax, row_axis=kt_ax)


# ---------------------------------------------------------------------------
# spec containers
# ---------------------------------------------------------------------------
def _qside_specs(w, kt_ax, nt_ax) -> dict:
    """The per-tile scale shards with the (Kt, Nt) grid; the codebook (a
    whole-matrix table) is replicated."""
    specs = {}
    if w.scale is not None:
        specs["scale"] = (kt_ax, nt_ax)
    if w.codebook is not None:
        specs["codebook"] = (None,) * w.codebook.ndim
    return specs


def packed_specs(w, kt_ax: str | None = None, nt_ax: str | None = None):
    """Container of the operand's type holding a spec tuple per tensor
    field, the (Kt, Nt) grid dims on the given axes."""
    if isinstance(w, TiledCSC):
        s = (kt_ax, nt_ax, None, None)
        return TiledCSC(vals=s, rows=s, shape=w.shape, tile=w.tile,
                        qmode=w.qmode, **_qside_specs(w, kt_ax, nt_ax))
    if isinstance(w, BlockCSR):
        return BlockCSR(
            block_vals=(kt_ax, nt_ax, None, None, None),
            block_ids=(kt_ax, nt_ax, None), tile_nnz=(kt_ax, nt_ax),
            shape=w.shape, tile=w.tile, br=w.br,
            qmode=w.qmode, **_qside_specs(w, kt_ax, nt_ax))
    raise TypeError(f"not a packed operand: {type(w)}")


def _validate(plan: SpmdPlan, mesh, w) -> None:
    names = set(mesh.axis_names)
    for a in plan.axes():
        if a not in names:
            raise ValueError(f"plan axis {a!r} not in mesh {mesh.axis_names}")
    kt, nt = _grid(w)
    if plan.col_axis and nt % mesh.shape[plan.col_axis]:
        raise ValueError(
            f"Nt={nt} not divisible by {plan.col_axis}={mesh.shape[plan.col_axis]}")
    if plan.gather_axis and nt % mesh.shape[plan.gather_axis]:
        raise ValueError(
            f"Nt={nt} not divisible by {plan.gather_axis}="
            f"{mesh.shape[plan.gather_axis]}")
    if plan.row_axis and kt % mesh.shape[plan.row_axis]:
        raise ValueError(
            f"Kt={kt} not divisible by {plan.row_axis}={mesh.shape[plan.row_axis]}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _axes_of(ax) -> tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def all_gather(t: torch.Tensor, mesh, axes, dim: int, kind: str) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` over the line of
    ``axes`` (in :meth:`~repro_torch.launch.mesh.Mesh.index` order); the
    tensor crosses as bytes, and the bytes received count under ``kind``."""
    axes = _axes_of(axes)
    n = _axes_size(mesh, axes)
    if n == 1:
        return t
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    _note(kind, nbytes * (n - 1), "all-gather", nbytes * n)
    if mesh.dry:
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)
    raw = t.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=mesh.group(axes))
    return torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts], dim=dim)


def all_reduce(t: torch.Tensor, mesh, axes, kind: str = "reduce_bytes") -> torch.Tensor:
    """Sum of every rank's ``t`` over the line of ``axes``, summed in
    float32 for a float tensor (float64 for a float64 one) and returned in
    its dtype (every rank gets the same bits)."""
    axes = _axes_of(axes)
    if _axes_size(mesh, axes) == 1:
        return t
    wide = torch.float64 if t.dtype == torch.float64 else torch.float32
    buf = t.to(wide, copy=True) if t.is_floating_point() else t.clone()
    nbytes = buf.numel() * buf.element_size()
    _note(kind, nbytes, "all-reduce", 2 * nbytes)
    if not mesh.dry:
        dist.all_reduce(buf, group=mesh.group(axes))
    return buf.to(t.dtype)


def all_to_all(t: torch.Tensor, mesh, axes, kind: str = "a2a_bytes") -> torch.Tensor:
    """The exchange of ``t``'s n equal blocks along dim 0 over the line of
    ``axes`` (n ranks): block i goes to the rank at position i, and block i
    of the result is what that rank sent here.  The tensor crosses as
    bytes (``gloo`` takes CPU and CUDA tensors for ``all_to_all_single``);
    the bytes received from the other ranks count under ``kind``."""
    axes = _axes_of(axes)
    n = _axes_size(mesh, axes)
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split over {n} ranks")
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    _note(kind, nbytes - nbytes // n, "all-to-all", nbytes)
    if mesh.dry:
        return torch.empty_like(t)
    raw = t.reshape(-1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=mesh.group(axes))
    return out.view(t.dtype).reshape(t.shape)


class _Exchange(torch.autograd.Function):
    """:func:`all_to_all` under autograd: the cotangent of block i came from
    the rank at position i, so the backward is the same exchange run the
    other way."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axes), None, None


def exchange(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Differentiable :func:`all_to_all` (its backward the reverse
    exchange)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Exchange.apply(t, mesh, axes)
    return all_to_all(t, mesh, axes)


def _own_block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = _axes_size(mesh, _axes_of(axes))
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size)


class _ShardRows(torch.autograd.Function):
    """This rank's block of a replicated tensor; the backward sums the
    block's cotangent over ``sum_axes`` (float32) and gathers the blocks,
    so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, sum_axes):
        ctx.args = (mesh, axes, dim, sum_axes)
        return _own_block(t, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, sum_axes = ctx.args
        if sum_axes:
            g = all_reduce(g, mesh, sum_axes, "grad_bytes")
        return all_gather(g, mesh, axes, dim, "grad_bytes"), None, None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's block, put together along ``dim``; the cotangent is
    replicated, so the backward takes this rank's block of it."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather(t, mesh, axes, dim, "output_bytes")

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _own_block(g, mesh, axes, dim).contiguous(), None, None, None


def shard_rows(t: torch.Tensor, mesh, axes, dim: int = 0, sum_axes=()) -> torch.Tensor:
    """This rank's block along ``dim`` of ``t``, the same on every rank of
    ``axes`` (blocks in :meth:`~repro_torch.launch.mesh.Mesh.index` order).
    Under autograd its gradient is every rank's block gathered, after a
    sum over ``sum_axes`` (the ranks that used the same block)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ShardRows.apply(t, mesh, axes, dim, _axes_of(sum_axes))
    return _own_block(t, mesh, axes, dim).contiguous()


def gather_rows(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` put together along ``dim`` over ``axes`` (the
    inverse of :func:`shard_rows`); under autograd the replicated
    cotangent's own block flows back."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherRows.apply(t, mesh, axes, dim)
    return all_gather(t, mesh, axes, dim, "output_bytes")


# ---------------------------------------------------------------------------
# the partitioned program
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Partition:
    """How a step lays its program over ``mesh``, as GSPMD partitions the
    reference's sharded step: the batch rows split over ``rows`` (the data
    axes where they divide the batch; none, every rank holding every row,
    where they do not), and heads, MLP columns and vocabulary over
    ``model``; in a decode step whose KV cache splits its sequence over
    ``model``, ``seq`` is the whole cache's length (None otherwise)."""

    mesh: object
    rows: tuple[str, ...] = ()
    seq: int | None = None

    @property
    def tp(self) -> int:
        """The ``model`` axis' size (1 without one)."""
        return self.mesh.shape.get("model", 1)

    @property
    def part(self) -> int:
        """This rank's position on ``model``: its block of every split
        feature dim."""
        return self.mesh.index("model") if self.tp > 1 else 0


def model_block(n: int) -> tuple[int, int] | None:
    """In the partitioned program, ``(first, count)`` of the rank's block
    of ``n`` units (heads) split over ``model``; None where ``n`` does not
    divide ``model`` (every rank keeps every unit) or outside a
    partitioned step."""
    part = active_partition()
    if part is None or part.tp == 1 or n % part.tp:
        return None
    count = n // part.tp
    return part.part * count, count


def seq_block() -> tuple[int, int] | None:
    """In a partitioned decode step whose KV cache splits its sequence
    over ``model``, ``(first, count)`` of the rank's block of positions;
    None otherwise."""
    part = active_partition()
    if part is None or part.seq is None:
        return None
    count = part.seq // part.tp
    return part.part * count, count


def active_partition() -> Partition | None:
    """The partition of the innermost open :func:`use_partition` block."""
    return _PARTITIONS[-1] if _PARTITIONS else None


@contextlib.contextmanager
def use_partition(part: Partition):
    """Run the block as the partitioned program of ``part`` (process-wide,
    as :func:`use_mesh`, for autograd's device threads)."""
    _PARTITIONS.append(part)
    try:
        yield part
    finally:
        for i in range(len(_PARTITIONS) - 1, -1, -1):
            if _PARTITIONS[i] is part:
                del _PARTITIONS[i]
                break


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of every rank's partial ``t``, whole on every
    rank; its cotangent is whole on every rank too, so it flows back to
    each partial as it is (the transpose of :func:`grad_sum`)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Psum.apply(t, mesh, axes)
    return all_reduce(t, mesh, axes)


def pmax(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The largest of every rank's ``t`` over ``axes`` (no gradient): every
    rank's gathered, then the largest taken (exact in any order; counted
    as an ``all-gather``)."""
    n = _axes_size(mesh, _axes_of(axes))
    if n == 1:
        return t.detach()
    return all_gather(t.detach()[None], mesh, axes, 0, "reduce_bytes").amax(dim=0)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args, "grad_bytes"), None, None


def grad_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t``, replicated over ``axes``, into work that each rank of them
    does a share of: the identity, whose backward sums the ranks' partial
    cotangents (the transpose of :func:`psum`)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GradSum.apply(t, mesh, axes)
    return t


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, start, size):
        ctx.args = (mesh, axes, dim, start, size, t.shape[dim])
        return t.narrow(dim, start, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, start, size, whole = ctx.args
        pad = [0, 0] * (g.ndim - 1 - dim % g.ndim) + [start, whole - start - size]
        return (all_reduce(F.pad(g, pad), mesh, axes, "grad_bytes"),
                None, None, None, None, None)


def take_block(t: torch.Tensor, mesh, axes, dim: int, start: int, size: int) -> torch.Tensor:
    """``t.narrow(dim, start, size)`` of a ``t`` replicated over ``axes``
    whose ranks each take a block (blocks may overlap): the backward puts
    each rank's cotangent at its block and sums them over ``axes``, so the
    replicated ``t`` gets its whole cotangent on every rank (the transpose
    of :func:`gather_rows`)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _TakeBlock.apply(t, mesh, _axes_of(axes), dim, start, size)
    return t.narrow(dim, start, size).contiguous()


def _block(t: torch.Tensor, mesh, kt_ax, nt_ax) -> torch.Tensor:
    """This rank's block of a grid-leading tensor ``(Kt, Nt, ...)``."""
    for dim, ax in ((0, kt_ax), (1, nt_ax)):
        if ax is not None:
            n = mesh.shape[ax]
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(ax) * size, size)
    return t.contiguous()


def _unblock(t: torch.Tensor, mesh, kt_ax, nt_ax, kind: str) -> torch.Tensor:
    """Inverse of :func:`_block`: the whole grid from every rank's block."""
    t = all_gather(t, mesh, nt_ax, 1, kind)
    return all_gather(t, mesh, kt_ax, 0, kind)


def _layout(w) -> tuple[str | None, str | None]:
    return (w.shard.kt_axis, w.shard.nt_axis) if w.shard else (None, None)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _keep(t):
    return t


class _Call:
    """One sharded product on this rank: the static layout of its local
    problem, and (with gradients) the local graph the backward reads."""

    def __init__(self, x: torch.Tensor, w, mesh, plan: SpmdPlan, impl: str,
                 bm, out_dtype, backend: str, params, fallback_params, local: bool = False):
        self.mesh, self.plan, self.w, self.local = mesh, plan, w, local
        self.run_kw = dict(impl=impl, bm=bm, params=params,
                           fallback_params=fallback_params)
        self.out_dtype, self.backend = out_dtype, backend
        self.fields = PACKED_FIELDS[type(w)]
        self.k, self.n = (int(s) for s in w.global_shape)
        kt, nt = _grid(w)
        bk, bn = (int(t) for t in w.tile)
        self.lead = tuple(x.shape[:-1])
        self.m = int(torch.Size(self.lead).numel())
        # the rows this product splits itself (none under the local
        # contract: they come split)
        self.dp = 1 if local else _axes_size(mesh, plan.batch_axes)
        self.m_local = -(-self.m // self.dp)
        self.row = mesh.shape[plan.row_axis] if plan.row_axis else 1
        self.col = mesh.shape[plan.col_axis] if plan.col_axis else 1
        # the local problem's logical shape: whole tile slabs on a split grid
        # dim (the padding tail is sliced off the gathered output)
        self.k_local = (kt // self.row) * bk if self.row > 1 else self.k
        self.n_local = (nt // self.col) * bn if self.col > 1 else self.n
        # under the local contract an exact split stays split: x comes as
        # its K block, y leaves as its column block
        self.row_in = local and self.row > 1 and kt * bk == self.k
        self.col_out = local and self.col > 1 and nt * bn == self.n
        self.k_in = self.k_local if self.row_in else self.k
        self.n_out = self.n_local if self.col_out else self.n
        self.resident = _layout(w)
        self.entry = (plan.row_axis, plan.col_axis or plan.gather_axis)
        self.mesh_sig = f"{mesh_key(mesh)}|{plan.signature()}"

    # -- the operand ---------------------------------------------------------
    def _local_fields(self, fields: dict) -> dict:
        """Resident block -> the plan's entry block -> the compute block
        (the whole Nt under a gather plan); the codebook stays as it is."""
        mesh, out = self.mesh, {}
        for name, t in fields.items():
            if t is None or name == "codebook":
                out[name] = t
                continue
            if self.resident != self.entry:
                if self.resident != (None, None):
                    t = _unblock(t, mesh, *self.resident, "reshard_bytes")
                t = _block(t, mesh, *self.entry)
            if self.plan.gather_axis:
                t = all_gather(t, mesh, self.plan.gather_axis, 1, "gather_bytes")
            out[name] = t
        return out

    def _resident_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The compute block's (batch-summed) gradient -> the resident
        block's: the gather plan's own Nt block, then resharded back."""
        mesh = self.mesh
        if name == "codebook":
            return g
        if self.plan.gather_axis:
            g = _block(g, mesh, None, self.plan.gather_axis)
        if self.resident != self.entry:
            if self.entry != (None, None):
                g = _unblock(g, mesh, *self.entry, "grad_bytes")
            g = _block(g, mesh, *self.resident)
        return g

    # -- forward / backward --------------------------------------------------
    def forward(self, x: torch.Tensor, fields: dict, grad: bool) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: runtime layers over kernels

        mesh, plan, dp = self.mesh, self.plan, self.dp
        x2 = x.reshape(-1, self.k_in)
        k_pad = self.k_local * self.row - self.k if self.row > 1 and not self.row_in else 0
        m_pad = self.m_local * dp - self.m
        if m_pad or k_pad:
            x2 = F.pad(x2, (0, k_pad, 0, m_pad))
        x_l = x2
        if dp > 1:
            x_l = x2.narrow(0, mesh.index(plan.batch_axes) * self.m_local, self.m_local)
        if self.row > 1 and not self.row_in:
            x_l = x_l.narrow(1, mesh.index(plan.row_axis) * self.k_local, self.k_local)
        x_l = x_l.contiguous()
        local = self._local_fields(fields)
        self.inputs = []
        if grad:
            x_l = x_l.detach().requires_grad_(x.requires_grad)
            local = {f: (t.detach().requires_grad_(fields[f].requires_grad)
                         if t is not None and t.is_floating_point() else t)
                     for f, t in local.items()}
            self.inputs = [(None, x_l)] if x.requires_grad else []
            self.inputs += [(f, t) for f, t in local.items()
                            if t is not None and t.requires_grad]
        w_l = dataclasses.replace(self.w, **local, shape=(self.k_local, self.n_local),
                                  shard=None)
        key = registry.problem_key(w_l, m=self.m_local, backend=self.backend,
                                   mesh=self.mesh_sig)
        chosen, run_params = ops.resolve(key, self.run_kw["impl"],
                                         params=self.run_kw["params"],
                                         bm=self.run_kw["bm"],
                                         fallback_params=self.run_kw["fallback_params"])
        token = _IN_BODY.set(True)
        try:
            # the local graph keeps its own saved tensors: inside a
            # checkpointed block (remat) the checkpoint's hooks would hand
            # them to a recompute that the backward's own autograd.grad
            # on this graph would trigger a second time
            with (torch.enable_grad() if grad else contextlib.nullcontext()), \
                    torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
                if x_l.device.type == "meta":
                    y_l = _shape_product(x_l, w_l, self.out_dtype)
                else:
                    y_l = chosen.run(x_l, w_l, out_dtype=self.out_dtype, **run_params)
        finally:
            _IN_BODY.reset(token)
        self.y_l = y_l
        y = y_l.detach()
        if plan.row_axis:
            y = all_reduce(y, mesh, plan.row_axis)
        if not self.col_out:
            y = all_gather(y, mesh, plan.col_axis, 1, "output_bytes")
        if dp > 1:
            y = all_gather(y, mesh, plan.batch_axes, 0, "output_bytes")
        return y[:self.m, :self.n_out].reshape(*self.lead, self.n_out)

    def backward(self, gy: torch.Tensor):
        mesh, plan, dp = self.mesh, self.plan, self.dp
        gy2 = gy.reshape(-1, self.n_out)
        n_pad = 0 if self.col_out else self.n_local * self.col - self.n
        gy2 = F.pad(gy2, (0, n_pad, 0, self.m_local * dp - self.m))
        gy_l = gy2
        if dp > 1:
            gy_l = gy2.narrow(0, mesh.index(plan.batch_axes) * self.m_local, self.m_local)
        if self.col > 1 and not self.col_out:
            gy_l = gy_l.narrow(1, mesh.index(plan.col_axis) * self.n_local, self.n_local)
        names = [f for f, _ in self.inputs]
        grads = dict(zip(names, torch.autograd.grad(
            self.y_l, [t for _, t in self.inputs],
            grad_outputs=gy_l.to(self.y_l.dtype).contiguous(), allow_unused=True)))
        self.y_l = self.inputs = None
        gx = grads.pop(None, None)
        if gx is not None:
            # x is whole over the column axis: its cotangent is the sum
            gx = all_reduce(gx, mesh, plan.col_axis)
            if not self.row_in:
                gx = all_gather(gx, mesh, plan.row_axis, 1, "output_bytes")
            if dp > 1:
                gx = all_gather(gx, mesh, plan.batch_axes, 0, "output_bytes")
            gx = gx[:self.m, :self.k_in].reshape(*self.lead, self.k_in)
        out = []
        for name in self.fields:
            g = grads.get(name)
            if g is not None:
                axes = plan.batch_axes
                if name == "codebook":   # every block of the product uses it
                    axes += _axes_of(plan.row_axis) + _axes_of(plan.col_axis)
                g = self._resident_grad(name, all_reduce(g, mesh, axes))
            out.append(g)
        return gx, out


def _shape_product(x: torch.Tensor, w, out_dtype: torch.dtype) -> torch.Tensor:
    """The local product on ``meta`` tensors (a counting mesh): ``x`` times
    the operand densified to its whole tiles (Kp, Np) in x's dtype, so a
    flop counter sees what the dense unit computes, 2·M·Kp·Np (and under
    autograd its two transposes), and autograd keeps what the kernel's
    backward keeps: ``x`` (no copy where K fills its tiles) beside the
    operand; nothing is computed."""
    (kt, nt), (bk, bn), (k, n) = w.grid, w.tile, w.shape
    dense = F.pad(w.to_dense().to(x.dtype), (0, nt * bn - n, 0, kt * bk - k))
    xp = x if kt * bk == k else F.pad(x, (0, kt * bk - k))
    return torch.matmul(xp, dense)[:, :n].to(out_dtype)


class _SpmdMatmul(torch.autograd.Function):
    """:class:`_Call` under autograd: inputs ``x`` and the operand's tensor
    fields, output the global ``y``."""

    @staticmethod
    def forward(ctx, call: _Call, x, *tensors):
        ctx.call = call
        return call.forward(x, dict(zip(call.fields, tensors)), grad=True)

    @staticmethod
    def backward(ctx, gy):
        gx, gw = ctx.call.backward(gy)
        ctx.call = None
        return (None, gx, *gw)


def sod_matmul_spmd(
    x: torch.Tensor,
    w,
    *,
    mesh=None,
    plan: SpmdPlan | None = None,
    impl: str = "auto",
    bm: int | None = None,
    out_dtype: torch.dtype | None = None,
    backend: str | None = None,
    params: dict | None = None,
    fallback_params: dict | None = None,
    local: bool = False,
) -> torch.Tensor:
    """``x @ W`` with the registry's kernel run by each rank on its local
    problem of ``plan`` (default: :func:`auto_plan`).

    ``x``: the global (..., K) on every rank; returns the global (..., N) on
    every rank.  Rows (and K under row parallelism) are zero-padded to
    divide the mesh and sliced off after.  ``w`` is whole or a resident
    block (``w.shard``).

    ``local=True``: the local contract (module docstring): ``x`` holds the
    rank's rows (split over ``plan.batch_axes`` already, or every row
    where the plan names none) and, under a row plan whose K splits
    exactly, its K block; ``y`` holds the same rows and, under a column
    plan whose N splits exactly, the rank's column block.  The weight's
    gradient is summed over the batch axes as under the global contract.
    """
    mesh = mesh or active_mesh()
    if mesh is None:
        raise ValueError("sod_matmul_spmd needs a mesh (argument or use_mesh)")
    if plan is None:
        plan = auto_plan(mesh, w)
        if plan is None:
            raise ValueError(f"no auto plan for {type(w).__name__} on "
                             f"{mesh_key(mesh)}")
    _validate(plan, mesh, w)
    call = _Call(x, w, mesh, plan, impl, bm, out_dtype or x.dtype,
                 backend or getattr(mesh, "backend", None)
                 or registry.current_backend(x.device), params, fallback_params,
                 local=local)
    if x.shape[-1] != call.k_in:
        raise ValueError(f"x inner dim {x.shape[-1]} != W K {call.k_in}"
                         + (" (its row block)" if call.row_in else ""))
    tensors = [getattr(w, f) for f in call.fields]
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t is not None and t.requires_grad for t in tensors)):
        return _SpmdMatmul.apply(call, x, *tensors)
    return call.forward(x, dict(zip(call.fields, tensors)), grad=False)


def local_plan(w, part: Partition) -> SpmdPlan:
    """The plan a packed product takes in the partitioned program: rows
    over ``part.rows`` and the weight as it lies (its resident block's Kt
    axis a row plan, its Nt axis a column plan), so no weight is
    resharded."""
    kt_ax, nt_ax = _layout(w)
    return SpmdPlan(batch_axes=part.rows, col_axis=nt_ax, row_axis=kt_ax)


def local_split(w) -> tuple[bool, bool]:
    """Whether the local contract takes ``x`` as its K block and gives ``y``
    as its column block for the resident ``w`` (a grid dim split over
    ``model`` with no padding tail)."""
    kt_ax, nt_ax = _layout(w)
    (kt, nt), (bk, bn), (k, n) = _grid(w), w.tile, w.global_shape
    return (kt_ax == "model" and kt * bk == k, nt_ax == "model" and nt * bn == n)


def sod_matmul_local(x: torch.Tensor, w, part: Partition, *, impl: str = "auto",
                     bm: int | None = None, out_dtype: torch.dtype | None = None,
                     backend: str | None = None, params: dict | None = None,
                     fallback_params: dict | None = None) -> torch.Tensor:
    """:func:`sod_matmul_spmd`'s local contract under :func:`local_plan`
    (what :func:`repro_torch.kernels.ops.sod_matmul` routes a packed
    product to inside the partitioned program).

    Where the weight's split dims split exactly, the rank's kernel runs on
    its block as an ordinary op of the
    step's graph (its saved tensors go through ``cfg.remat``'s
    checkpoint like any other op's): the weight's float fields pass
    through :func:`grad_sum` over the batch axes (the codebook also over
    the weight's axes), ``x`` through :func:`grad_sum` over a column
    plan's axis, and a row plan's partial products through :func:`psum`.
    Elsewhere it takes :func:`sod_matmul_spmd` with ``local=True``."""
    mesh, plan = part.mesh, local_plan(w, part)
    out_dtype = out_dtype or x.dtype
    backend = backend or getattr(mesh, "backend", None) or registry.current_backend(x.device)
    row_in, col_out = local_split(w)
    if (plan.row_axis and not row_in) or (plan.col_axis and not col_out):
        return sod_matmul_spmd(x, w, mesh=mesh, plan=plan, impl=impl, bm=bm,
                               out_dtype=out_dtype, backend=backend, params=params,
                               fallback_params=fallback_params, local=True)
    from repro_torch.kernels import ops  # deferred: runtime layers over kernels

    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"x inner dim {x.shape[-1]} != the block's K {w.shape[0]}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    fields = {f: getattr(w, f) for f in PACKED_FIELDS[type(w)]}
    if torch.is_grad_enabled():
        if plan.col_axis:           # x is whole over the column axis
            x2 = grad_sum(x2, mesh, plan.col_axis)
        weight_axes = _axes_of(plan.row_axis) + _axes_of(plan.col_axis)
        fields = {f: grad_sum(t, mesh, plan.batch_axes + (weight_axes if f == "codebook"
                                                          else ()))
                  if t is not None and t.requires_grad else t for f, t in fields.items()}
    w_l = dataclasses.replace(w, **fields, shard=None)
    key = registry.problem_key(w_l, m=x2.shape[0], backend=backend,
                               mesh=f"{mesh_key(mesh)}|{plan.signature()}")
    chosen, run_params = ops.resolve(key, impl, params=params, bm=bm,
                                     fallback_params=fallback_params)
    token = _IN_BODY.set(True)
    try:
        if x2.device.type == "meta":
            y = _shape_product(x2, w_l, out_dtype)
        else:
            y = chosen.run(x2, w_l, out_dtype=out_dtype, **run_params)
    finally:
        _IN_BODY.reset(token)
    if plan.row_axis:
        y = psum(y, mesh, plan.row_axis)
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# per-shard autotuning
# ---------------------------------------------------------------------------
def _local_packed(w, mesh, plan: SpmdPlan):
    """A concrete one-shard slice of a whole ``w`` under ``plan`` — the
    local problem a rank's kernel sees, for single-device tuning."""
    kt, nt = _grid(w)
    row = mesh.shape[plan.row_axis] if plan.row_axis else 1
    col = mesh.shape[plan.col_axis] if plan.col_axis else 1
    if row == 1 and col == 1:
        return w
    bk, bn = (int(t) for t in w.tile)
    kt_l, nt_l = kt // row, nt // col
    k_l = kt_l * bk if row > 1 else int(w.shape[0])
    n_l = nt_l * bn if col > 1 else int(w.shape[1])
    fields = {f: (t if t is None or f == "codebook" else t[:kt_l, :nt_l].contiguous())
              for f, t in ((f, getattr(w, f)) for f in PACKED_FIELDS[type(w)])}
    return dataclasses.replace(w, **fields, shape=(k_l, n_l))


def _packed_leaves(tree):
    if isinstance(tree, (TiledCSC, BlockCSR)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packed_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _packed_leaves(v)


def warmup_params_spmd(params, m_values, mesh, *, plan: SpmdPlan | None = None,
                       backend: str | None = None, cache=None, iters: int = 1,
                       seed: int = 0) -> dict:
    """Tune every distinct packed layout at its per-local-shard shape under
    the mesh-qualified key, so a mesh run's local dispatches hit the cache.
    ``m_values`` are *global* row counts (the local m is derived per plan).
    Returns ``{"tuned", "cached", "skipped"}``."""
    from repro_torch.kernels import autotune

    cache = autotune.get_cache() if cache is None else cache
    stats = {"tuned": 0, "cached": 0, "skipped": 0}
    seen: set = set()
    for leaf in _packed_leaves(params):
        if leaf.lead:
            continue
        p = plan or auto_plan(mesh, leaf)
        if p is None:
            stats["skipped"] += 1
            continue
        try:
            _validate(p, mesh, leaf)
        except ValueError:
            stats["skipped"] += 1
            continue
        local = _local_packed(leaf, mesh, p)
        sig = (type(leaf).__name__, tuple(local.shape), str(local.dtype),
               tuple(local.tile), p.signature())
        if sig in seen:
            continue
        seen.add(sig)
        mesh_sig = f"{mesh_key(mesh)}|{p.signature()}"
        dp = _axes_size(mesh, p.batch_axes)
        dtype = local.dtype if local.qmode == "none" else torch.bfloat16
        for m in dict.fromkeys(int(v) for v in m_values):
            m_local = max(-(-m // dp), 1)
            pk = registry.problem_key(local, m=m_local, backend=backend, mesh=mesh_sig)
            if cache.get(pk) is not None:
                stats["cached"] += 1
                continue
            gen = torch.Generator(device=local.device)
            gen.manual_seed((seed + zlib.crc32(repr(sig).encode()) ^ m) % (2**31))
            x = torch.randn(m_local, local.shape[0], generator=gen,
                            device=local.device).to(dtype)
            autotune.tune(x, local, backend=backend, mesh=mesh_sig, cache=cache,
                          iters=iters)
            stats["tuned"] += 1
    return stats
