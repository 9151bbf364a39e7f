"""The port, chip_smoke.py and the port's probe scripts import neither JAX
nor the JAX package, nor ``ml_dtypes`` (which comes with JAX)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "sod_matmul_probe.py",
    ROOT / "scripts" / "serve_probe.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    # "repro_torch" is a different top
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_forbidden_rule_tells_repro_torch_apart():
    assert _forbidden("repro") and _forbidden("repro.core.sod")
    assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.core.sod")


def test_importing_the_serve_path_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.interop, "
            "repro_torch.launch.train, repro_torch.kernels.vjp, "
            "repro_torch.optim.grad, repro_torch.checkpoint, "
            "repro_torch.runtime.fault, "
            "repro_torch.serving, repro_torch.obs, repro_torch.kernels.registry, "
            "repro_torch.kernels.autotune, repro_torch.kernels.timing, "
            "repro_torch.runtime.planner, repro_torch.models.ssm, "
            "repro_torch.models.xlstm, repro_torch.configs.zamba2_2_7b, "
            "repro_torch.configs.xlstm_125m, "
            "repro_torch.core.plan, repro_torch.core, repro_torch.core.cost_model; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120, cwd=ROOT)
