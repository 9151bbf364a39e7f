"""The import check (JAX and the JAX package, by whole top-level name), the
reference's independence from the program, and the runs that must print no
result."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types

from perfbench import run
from perfbench.harness import runner, spec

BENCH = spec.BENCH_DIR
ROOT = spec.ROOT


def test_forbidden_names_are_whole_top_level_names():
    assert runner.forbidden_modules(["repro_torch", "repro_torch.serving.engine",
                                     "reprox", "jaxtyping", "numpy"]) == []
    assert runner.forbidden_modules(["repro.core.sod", "repro_torch"]) == ["repro"]
    assert runner.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(runner.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert set(_imports(path)) <= {"__future__", "dataclasses", "typing", "torch"}, path


def test_no_source_reads_the_jax_packages_benchmarks():
    for path in BENCH.rglob("*.py"):
        if path.parent.name != "tests":
            assert "benchmarks" not in set(_imports(path)) and '"benchmarks' not in path.read_text()


class _Fake:
    """A run with the chip and the window replaced, to see what ``main``
    prints."""

    def __init__(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(runner, "measure", lambda *a, **k: {"cell": a[1]})
        monkeypatch.setattr(run, "_environment", lambda: None)
        self.emitted = []
        monkeypatch.setattr(runner, "emit", lambda *a, **k: self.emitted.append(a))

    def main(self):
        return run.main(["--workload", "internlm2_decode128", "--seed", str(2**31 + 5),
                         "--seconds", "1", "--trace", "0"])


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    fake = _Fake(monkeypatch)
    assert fake.main() == 0 and len(fake.emitted) == 1
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert fake.main() != 0
    assert len(fake.emitted) == 1
    assert "jax" in capsys.readouterr().err
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert fake.main() != 0 and len(fake.emitted) == 1


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "internlm2_decode128",
                           "--seed", "7", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result(cuda_absent):
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no program" in out.stderr


def test_the_result_line_is_the_last_line(monkeypatch, capsys):
    """``emit`` prints the side lines, then one JSON object with the keys
    the contract names and the compared numbers last."""
    res = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
           "device": {"platform": "gpu"}, "checks": {"max_logit_gap": {"value": 0.1,
                                                                      "limit": 0.2}}}
    monkeypatch.setattr(runner, "result", lambda *a: res)
    monkeypatch.setattr(runner, "side_lines", lambda rec: [{"setup_split": {}}])
    runner.emit({}, {}, False, {})
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert list(last)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check max_logit_gap 0.1 limit 0.2"
