"""The PyTorch port stands alone: no module of sheeprl_tpu_torch, and neither
chip_smoke.py nor ln_gru_breakdown.py, imports jax, flax, optax, gymnasium
(the machine with the card has none of them) or the JAX package.

tests/conftest.py imports jax in this process and moves the working
directory, so the import check runs in a fresh subprocess with PYTHONPATH set
to the repo root; an AST scan also finds any such import statement, including
ones inside functions that the import check does not run.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_helpers import SUBPROCESS_ENV

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "gymnasium", "sheeprl_tpu")


SCRIPTS = ["chip_smoke", "ln_gru_breakdown"]  # the port's scripts at the root of the repo


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / f"{name}.py" for name in SCRIPTS]


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_every_module_loads_no_jax():
    modules = _module_names() + SCRIPTS
    script = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", script], env=env, cwd=str(REPO), capture_output=True, text=True, timeout=240
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    assert len(modules) > 20


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if node.module.split(".")[0] in FORBIDDEN:
                found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and str(arg.value).split(".")[0] in FORBIDDEN:
                found.append(arg.value)
    assert not found, f"{path.relative_to(REPO)} imports {found}"


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result line; alone in
    a directory (no package beside it) it fails too."""
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], env=env, cwd=str(REPO), capture_output=True, text=True, timeout=240
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(alone)], env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=240
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
