"""The port's whole-module copies are the reference's code.

Where the reference's module is plain Python, the port keeps its own copy
(the port imports nothing of ``repro``).  For each such copy, the module's
AST with its docstring dropped and ``repro_torch`` read as ``repro`` must
equal the reference module's AST with its docstring dropped: a copy may
differ only in its docstring and its import paths.
"""

import ast
from pathlib import Path

import pytest

from _subproc import REPO_ROOT

SRC = Path(REPO_ROOT) / "src"
COPIES = (
    "core/discipline.py",
    "core/policy.py",
    "core/topology.py",
    "core/numasim.py",
    "core/locks_sim.py",
    "core/cna.py",
    "placement/__init__.py",
    "placement/freelists.py",
    "placement/policy.py",
    "placement/telemetry.py",
    "placement/controller.py",
    "serving/scheduler.py",
    "serving/prefixkv.py",
    "serving/prefixindex.py",
    "obs/trace.py",
    "configs/granite_3_8b.py",
    "configs/mamba2_130m.py",
    "configs/recurrentgemma_2b.py",
)


def _body(text: str) -> str:
    tree = ast.parse(text)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def test_copy_list_is_complete():
    assert len(COPIES) == len(set(COPIES)) == 18


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    port = (SRC / "repro_torch" / rel).read_text()
    ref = (SRC / "repro" / rel).read_text()
    assert "repro_torch" not in ref
    assert _body(port.replace("repro_torch", "repro")) == _body(ref)
