"""Checkpointing with async save — twin of :mod:`repro.checkpoint.checkpointer`.

The reference's layout per step::

    <dir>/step_<N>/MANIFEST.msgpack      # leaf paths, shapes, dtypes
    <dir>/step_<N>/<leaf-index>.npy      # one array per leaf
    <dir>/step_<N>/COMMITTED             # write-completion marker

A step is written into a temporary directory and renamed into place, and
only a directory holding the COMMITTED marker counts: a crashed save is
done again, never restored.  ``save(blocking=False)`` copies every leaf to
the host synchronously (the step loop may then change the tensors in
place) and writes from a daemon thread.  numpy has no bfloat16 or float8,
and the port does without ``ml_dtypes``.  A bfloat16 leaf is stored
through its bits (``uint16``), as the reference stores it.  A float8 leaf
is stored as float16 *values*, which hold every e4m3 value (NaNs and -0.0
included) exactly, so the reference's restore, which casts such an array to
its template's dtype by value, reads it right; it takes 2 bytes an element
on disk.  Both are named by their dtype in the manifest.  ``restore`` reads
a float8 leaf by value from float16, and through its bits from ``uint8``
(the port's older checkpoints) or from the ``|V1`` array numpy loads for
the reference's float8 leaf; it then casts every leaf to its template's
dtype and moves it to the template's device.  A packed container's fields
are named ``<path>.vals`` here and ``<path>[<flat index i>]`` by the
reference (its i-th array child, None fields skipped); ``restore`` reads
either.
``history`` records every save: its step, the seconds of the host copy and
of the writes, and the bytes written.
``restore(shardings=(specs, mesh))`` places each leaf it reads as
:func:`repro_torch.runtime.sharding.place` places it on that mesh (the
reference's ``NamedSharding`` tree): the mesh may differ from the one that
saved, as in an elastic re-shard.  A mesh run saves the whole state, its
packed leaves gathered back (:func:`repro_torch.runtime.sharding.unplace`).
"""
from __future__ import annotations

import os
import pathlib
import shutil
import threading
import time
from typing import Any

import msgpack
import numpy as np
import torch

from repro_torch.core.tree import PACKED_FIELDS, leaves_with_path, tree_map, tree_map_with_path

Params = Any
_COMMITTED = "COMMITTED"
# manifest name -> torch dtype of the leaves numpy cannot hold
_FROM_NAME = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and its dtype's name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:        # through its bits, as the reference
        return t.view(torch.uint16).numpy(), "bfloat16"
    if t.dtype == torch.float8_e4m3fn:   # by value: float16 holds every e4m3 value
        return t.to(torch.float16).numpy(), "float8_e4m3fn"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    """The leaf ``arr`` holds, in the dtype ``name``: bits (uint16 for
    bfloat16; uint8 or a 1-byte void array for float8) are viewed, float16
    values of a float8 leaf are cast (exactly)."""
    if arr.dtype.kind == "V":      # the reference's float8 leaf: numpy's |V1
        arr = arr.view(np.uint8)
    t = torch.from_numpy(arr)      # np.load gives a C-contiguous array, 0-d kept
    dtype = _FROM_NAME.get(name)
    if dtype is None:
        return t
    if t.element_size() == dtype.itemsize and not t.is_floating_point():
        return t.view(dtype)
    return t.to(dtype)


_FIELD_NAMES = {f for fields in PACKED_FIELDS.values() for f in fields}


def _reference_names(template: Params) -> dict[str, str]:
    """Each packed field's name in a checkpoint the reference wrote: the
    index of the field among its container's array children, in the order
    both packages walk them (None fields are no children)."""
    out, seen = {}, {}
    for name, _ in leaves_with_path(template):
        head, dot, field = name.rpartition(".")
        if dot and field in _FIELD_NAMES:
            i = seen[head] = seen.get(head, -1) + 1
            out[name] = f"{head}[<flat index {i}>]"
    return out


class Checkpointer:
    """Save and restore state trees (dicts, lists, packed containers of
    tensors) under one directory, keeping the last ``keep`` steps."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.history: list[dict] = []

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Params, blocking: bool = True) -> None:
        """Write ``state`` as step ``step``; with ``blocking=False`` the host
        copy is taken now and the files are written by a daemon thread."""
        self.wait()   # one writer at a time; drain a pending async save
        t0 = time.perf_counter()
        host = [(name, *_to_numpy(leaf)) for name, leaf in leaves_with_path(state)]
        record = {"step": step, "host_s": time.perf_counter() - t0,
                  "bytes": sum(arr.nbytes for _, arr, _ in host), "blocking": blocking}
        self.history.append(record)
        if blocking:
            self._write(step, host, record)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host, record), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Block until a pending async save is written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, record: dict) -> None:
        t0 = time.perf_counter()
        path = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}_{id(host):x}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = []
        for i, (name, arr, dtype) in enumerate(host):
            np.save(tmp / f"{i}.npy", arr)
            manifest.append({"name": name, "index": i, "shape": list(arr.shape),
                             "dtype": dtype})
        (tmp / "MANIFEST.msgpack").write_bytes(
            msgpack.packb({"step": step, "leaves": manifest}))
        (tmp / _COMMITTED).touch()
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        self._gc()
        record["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Committed steps, ascending."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if (p / _COMMITTED).exists())

    def latest_step(self) -> int | None:
        """The last committed step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Params, shardings=None) -> Params:
        """Step ``step`` in ``template``'s structure, every leaf cast to its
        template leaf's dtype on its device.  Raises FileNotFoundError for an
        uncommitted step and KeyError for a leaf the checkpoint lacks.

        ``shardings``, a ``(specs, mesh)`` pair, places the whole leaves read
        from disk on ``mesh`` (:func:`repro_torch.runtime.sharding.place`):
        each rank keeps its resident blocks, each on its template leaf's
        device (an optimizer's step counter stays on the CPU).  ``template``
        may then be whole or placed on any mesh; only its structure, dtypes
        and devices are read."""
        path = self.dir / f"step_{step:08d}"
        if not (path / _COMMITTED).exists():
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        manifest = msgpack.unpackb((path / "MANIFEST.msgpack").read_bytes())
        by_name = {m["name"]: m for m in manifest["leaves"]}
        theirs = _reference_names(template)

        def load(name: str, tmpl: torch.Tensor) -> torch.Tensor:
            meta = by_name.get(name) or by_name.get(theirs.get(name))
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = _from_numpy(np.load(path / f"{meta['index']}.npy"), meta["dtype"])
            return t.to(device=tmpl.device, dtype=tmpl.dtype)

        out = tree_map_with_path(load, template)
        if shardings is None:
            return out
        from repro_torch.runtime import sharding  # deferred: checkpoint under runtime

        specs, mesh = shardings
        return tree_map(lambda t, tmpl: t.to(tmpl.device),
                        sharding.place(sharding.whole(out), specs, mesh), template)
