"""The import guard: nothing under port_bench/ imports JAX, jaxlib, flax or
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ssad_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "ssad_tpu_torch" not in top_level_imports(path)


def test_whole_names(tmp_path):
    """The port's own name passes; the JAX package's does not."""
    f = tmp_path / "m.py"
    f.write_text("import ssad_tpu_torch.ops\nfrom ssad_tpu.ops import knn\n")
    assert top_level_imports(f) & FORBIDDEN == {"ssad_tpu"}
    assert len(SOURCES) > 10
