"""The PyTorch port stands alone: no file of githubrepostorag_tpu_torch (nor
chip_smoke.py, nor its CQL stand-in tests/torch_minicassandra.py) imports
jax or the JAX package.  Checked on the source's AST,
not on sys.modules: the test process itself imports jax."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py imports tests/torch_minicassandra.py, its CQL stand-in
PORT_FILES = sorted((ROOT / "githubrepostorag_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_minicassandra.py"]
FORBIDDEN = ("jax", "jaxlib", "githubrepostorag_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_files():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
