"""No module of gnnbench/ imports JAX or the JAX package (the top-level
name compared whole: the port's name begins with the JAX package's), and
the references and the input generator import nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "isplib_tpu"}


@pytest.mark.parametrize("path", [HERE / "gen.py", HERE / "control.py",
                                  HERE / "check.py", HERE / "bound.py",
                                  *sorted((HERE / "reference").glob("*.py")),
                                  *sorted((HERE / "counts").glob("*.py"))],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "isplib_tpu_torch" not in imported(path)
