"""The port stands alone: it never imports JAX or the JAX package.

The import check runs in a subprocess with ``jax`` poisoned in its
``sys.modules``, so nothing in the pytest process's module table is
touched.  An AST scan covers every source of the port and ``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _subproc import REPO_ROOT, run_env  # noqa: E402

PORT = Path(REPO_ROOT) / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [Path(REPO_ROOT) / "chip_smoke.py"]

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # defines, runs nothing at import
bad = sorted(m for m, mod in sys.modules.items() if mod is not None  # None: the poison
             and (m == "repro" or m.startswith("repro.") or m.startswith("jax")))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_repro():
    env = run_env()
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO_ROOT, "src"), REPO_ROOT])
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=env, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO_ROOT)) for p in SOURCES])
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_sources_scanned():
    assert len(SOURCES) >= 20 and (Path(REPO_ROOT) / "chip_smoke.py").exists()
