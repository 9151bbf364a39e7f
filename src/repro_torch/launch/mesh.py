"""Meshes of ranks — twin of :mod:`repro.launch.mesh`.

The reference lays a jax device mesh over its chips.  The port's mesh is a
process group: one rank per mesh position, in row-major order over the axes
(rank ``r`` sits at ``numpy.unravel_index(r, sizes)``, as the reference
reshapes its device list), and one process group per line of every set of
axes, so a collective over ``("data",)`` or ``("data", "model")`` runs
among exactly the ranks that share the other coordinates.

* :class:`AbstractMesh` — names and sizes, no group: what the partition
  rules (:mod:`repro_torch.runtime.sharding`) and the planner's mesh pass
  read.  :func:`make_production_mesh` is one: the port has no 256 ranks.
* :class:`Mesh` — an abstract mesh plus this rank's coordinates, its device
  and its groups, over a default group the caller has initialised with its
  backend (:func:`make_test_mesh`, :func:`make_fake_mesh`).
* :class:`DryMesh` — the counting mesh of the dry-run
  (:mod:`repro_torch.launch.dryrun`): one rank's coordinates of a
  production mesh (:func:`make_dry_mesh`) and no process group.  On it the
  port's collectives count what they would move and return ``meta``
  tensors of the right shape, and each packed product resolves its kernel
  as the card would and computes only its shape: nothing launches.
* :func:`mesh_context` — the mesh that packed matmuls route through
  (:mod:`repro_torch.runtime.spmd`) while the block runs.
* :func:`run_ranks` — starts N ranks as subprocesses over a ``FileStore``
  in a given directory, each calling one function, and collects what each
  returns; a rank that fails or outlives the time limit fails the run.

Run one rank by hand: ``python -m repro_torch.launch.mesh --rank R --world
N --store DIR/store --out DIR/rankR.json --target module:function [ARGS]``
(what :func:`run_ranks` starts).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import importlib
import importlib.util
import itertools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "Mesh", "DryMesh", "make_production_mesh", "make_dry_mesh",
           "make_test_mesh", "make_fake_mesh", "mesh_context", "dp_axes", "tp_axis", "run_ranks",
           "GROUP_TIMEOUT", "FAKE_MESH_SHAPE"]

# every group's collective timeout: a rank that dies fails its peers' next
# collective instead of hanging them
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
FAKE_MESH_SHAPE = (4, 2)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks (the twin of
    ``jax.sharding.AbstractMesh``)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    dry = False        # True on a counting mesh (:class:`DryMesh`)

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for {self.axis_names} axes")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order (jax's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Number of mesh positions."""
        return int(np.prod(self.axis_sizes))


class _RankMesh(AbstractMesh):
    """An abstract mesh seen from one rank: ``rank`` and ``coords``."""

    def _set_rank(self, rank: int, device) -> None:
        object.__setattr__(self, "rank", int(rank))
        object.__setattr__(self, "device", torch.device(device))
        object.__setattr__(self, "coords", dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(self.rank, self.axis_sizes)))))

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def index(self, axes) -> int:
        """This rank's row-major position over ``axes`` (0 for no axes)."""
        idx = 0
        for a in self._axes(axes) if axes else ():
            idx = idx * self.shape[a] + self.coords[a]
        return idx


class Mesh(_RankMesh):
    """An :class:`AbstractMesh` over an initialised default process group:
    this rank's ``coords``, its ``device``, and a group per line of every
    set of axes (:meth:`group`), each created with :data:`GROUP_TIMEOUT`."""

    def __init__(self, axis_sizes, axis_names, device: torch.device):
        super().__init__(tuple(int(s) for s in axis_sizes), tuple(axis_names))
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs the default process group: call "
                               "torch.distributed.init_process_group first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the "
                             f"group has {dist.get_world_size()}")
        self._set_rank(dist.get_rank(), device)
        # every rank creates every group, in one order (new_group is collective)
        groups = {}
        grid = np.arange(self.size).reshape(self.axis_sizes)
        for n_axes in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(range(len(self.axis_names)), n_axes):
                rest = [d for d in range(len(self.axis_names)) if d not in axes]
                lines = np.transpose(grid, rest + list(axes)).reshape(
                    -1, int(np.prod([self.axis_sizes[d] for d in axes])))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [sorted(int(r) for r in line) for line in lines],
                    timeout=GROUP_TIMEOUT)
                groups[tuple(self.axis_names[d] for d in axes)] = mine
        object.__setattr__(self, "_groups", groups)

    def group(self, axes):
        """The process group of this rank's line over ``axes`` (one name or
        several, taken in mesh order); its ranks are ordered as
        :meth:`index` counts them."""
        return self._groups[self._axes(axes)]


class DryMesh(_RankMesh):
    """One rank of a mesh with no process group: the dry-run's counting mesh.

    :mod:`repro_torch.runtime.spmd`'s collectives on it move nothing: they
    count the bytes they would move into :func:`~repro_torch.runtime.spmd.
    count_collectives` and return ``meta`` tensors of the shape a real group
    gives.  A packed product resolves its kernel for ``backend``, the
    card's, with the mesh-qualified key, notes that choice in the dispatch
    log, and computes its shape through the plain version on ``meta``:
    nothing launches, and every tensor of a run on it is on
    ``device="meta"``."""

    dry = True
    backend = "cuda"

    def __init__(self, axis_sizes, axis_names, rank: int = 0):
        super().__init__(tuple(int(s) for s in axis_sizes), tuple(axis_names))
        if not 0 <= int(rank) < self.size:
            raise ValueError(f"rank {rank} outside mesh {self.shape}")
        self._set_rank(rank, "meta")

    def group(self, axes):
        raise RuntimeError("a DryMesh has no process group: its collectives only count")


def make_dry_mesh(*, multi_pod: bool = False) -> DryMesh:
    """Rank 0 of the production mesh (:func:`make_production_mesh`) as a
    counting mesh."""
    m = make_production_mesh(multi_pod=multi_pod)
    return DryMesh(m.axis_sizes, m.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production layouts, (16, 16) ``(data, model)`` or
    (2, 16, 16) ``(pod, data, model)``, as abstract meshes: the partition
    rules and the planner read them; nothing runs on 256 ranks here."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> Mesh:
    """A mesh over the initialised default group (``prod(shape)`` ranks).
    ``device`` defaults to the card; tests pass ``"cpu"``."""
    return Mesh(shape, axes, torch.device(device or "cuda"))


def make_fake_mesh(shape=FAKE_MESH_SHAPE, axes=("data", "model"), device=None) -> Mesh:
    """The reference's spmd-tier mesh, (data=4, model=2), over 8 ranks."""
    return make_test_mesh(shape, axes, device)


def mesh_context(mesh):
    """``with mesh_context(m):`` — packed matmuls in the block route through
    the mesh (:func:`repro_torch.runtime.spmd.use_mesh`); a no-op for None."""
    if mesh is None:
        return contextlib.nullcontext()
    from repro_torch.runtime import spmd  # deferred: runtime over launch helpers

    return spmd.use_mesh(mesh)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch (pod joins data parallelism)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    """The tensor-parallel axis."""
    return "model"


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------
def _resolve(target: str):
    """``module:function`` or ``path/to/file.py:function``."""
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            pathlib.Path(where).stem + "_rank", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _tail(path: pathlib.Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_ranks(n: int, target: str, workdir, *, args=(), timeout: float = 300.0) -> list:
    """Start ``n`` ranks as subprocesses, each initialising a ``gloo``
    default group over a ``FileStore`` in ``workdir`` with one torch thread
    and calling ``target(*args)``; returns each rank's return value (JSON),
    in rank order.

    A rank that exits non-zero, or a run that outlives ``timeout`` seconds,
    kills every rank and raises ``RuntimeError`` with the failing rank's
    log (``workdir/rank<r>.log``)."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for r in range(n):
        log = open(workdir / f"rank{r}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.mesh", "--rank", str(r),
               "--world", str(n), "--store", str(store),
               "--out", str(workdir / f"rank{r}.json"), "--target", target,
               *map(str, args)]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                       env=env), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = next((r for r, (p, _) in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"{n} ranks of {target} outlived {timeout:.0f} s; "
                                   f"rank 0 log:\n{_tail(workdir / 'rank0.log')}")
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, (p, _) in enumerate(procs) if p.returncode), None)
        if failed is not None:
            raise RuntimeError(
                f"rank {failed} of {target} exited {procs[failed][0].returncode}:\n"
                f"{_tail(workdir / f'rank{failed}.log')}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(n)]


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--target", required=True)
    args, rest = ap.parse_known_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=GROUP_TIMEOUT)
    try:
        result = _resolve(args.target)(*rest)
        if dist.is_initialized():      # a rank that left a re-mesh has no group
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    pathlib.Path(args.out).write_text(json.dumps(result))


if __name__ == "__main__":
    _rank_main()
