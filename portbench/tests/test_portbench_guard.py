"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package ``repro``, compared by whole top-level name (``repro_torch``
begins with ``repro`` and is allowed outside the reference); the plain
reference imports nothing of the program either."""

import ast
import pathlib

import pytest

from portbench import bench

PKG = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_forbidden_modules_compares_whole_names():
    assert bench.forbidden_modules(["repro_torch.gateway", "reprox", "numpy"]) == []
    assert bench.forbidden_modules(["repro.gateway", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]
