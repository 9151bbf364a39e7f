"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric lives in a file of its own under
``perfbench/``; nothing here lists them, so a later change adds a file and
an entry and edits nothing:

* ``configs/<name>.json`` (the path the configuration's entry gives),
* ``arch/<architectures>.py``: the configuration's architecture (its
  ``architectures``, as the published ``config.json`` names it): the
  port's model config, the raw weights in the port's layout, and the
  reference's side (:mod:`perfbench.harness.dense` documents the interface),
* ``traffic/<mix>.json``: a mix's parameters, and ``traffic/<kind>.py``,
  the generator and window loop of every mix of that ``kind``
  (``closed_loop.py`` documents the interface),
* ``limits/<cell>.json`` (the numbers ``correct`` is judged by),
* ``metrics/<metric>.py`` (a reader: ``read(rec) -> float | None``).

Modules are loaded by path (names may hold dots or capitals), each once a
path.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Any, Callable

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: pathlib.Path | str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    """The parsed ``BENCHMARK.json`` at ``root``."""
    return load_json(root / "BENCHMARK.json")


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(sorted(e["name"] for e in entries))
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json (known: {known})")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry of cell ``name``."""
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """Configuration ``name``'s file, with its entry's ``name`` beside it."""
    entry = _named(bench["configs"], name, "configuration")
    return {**load_json(root / entry["file"]), "name": name}


def traffic(mix: str, base: pathlib.Path = BENCH_DIR) -> dict:
    """Traffic mix ``mix``: ``traffic/<mix>.json``."""
    return {**load_json(base / "traffic" / f"{mix}.json"), "name": mix}


def load_module(path: pathlib.Path, prefix: str) -> ModuleType:
    """The module in file ``path``, executed once and kept in
    ``sys.modules`` under a name made from ``prefix`` and the path."""
    path = pathlib.Path(path).resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:10]
    stem = "".join(c if c.isalnum() else "_" for c in path.stem)
    name = f"perfbench_{prefix}_{stem}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mspec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mspec)
    sys.modules[name] = mod
    try:
        mspec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def traffic_kind(mix: dict, base: pathlib.Path = BENCH_DIR) -> ModuleType:
    """The generator and window loop of ``mix``: ``traffic/<kind>.py``."""
    return load_module(base / "traffic" / f"{mix['kind']}.py", "traffic")


def architecture(cfg: dict, base: pathlib.Path = BENCH_DIR) -> ModuleType:
    """The module of configuration ``cfg``'s architecture:
    ``arch/<architectures>.py`` (a list of one name, as a published
    ``config.json`` gives it, or the name)."""
    name = cfg["architectures"]
    if isinstance(name, list):
        if len(name) != 1:
            raise ValueError(f"one architecture a configuration, not {name}")
        name = name[0]
    return load_module(base / "arch" / f"{name}.py", "arch")


def limits(cell_name: str, base: pathlib.Path = BENCH_DIR) -> dict:
    """Cell ``cell_name``'s limits: ``limits/<cell>.json``."""
    return load_json(base / "limits" / f"{cell_name}.json")


def metric_reader(name: str, base: pathlib.Path = BENCH_DIR) -> Callable[[dict], Any]:
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module(base / "metrics" / f"{name}.py", "metric").read


def listing(kind: str, base: pathlib.Path = BENCH_DIR, suffix: str | None = None) -> list[str]:
    """Names of the files of one kind (``traffic``, ``metrics``, ``arch``,
    ``configs``, ``limits``) present under ``base``: ``.py`` files of
    ``metrics`` and ``arch``, ``.json`` files of the others (``suffix``
    overrides: ``listing("traffic", suffix=".py")`` lists the kinds)."""
    suffix = suffix or (".py" if kind in ("metrics", "arch") else ".json")
    return sorted(p.name[: -len(suffix)] for p in (base / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``cell_name``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
