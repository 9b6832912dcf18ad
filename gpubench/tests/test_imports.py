"""Nothing under gpubench/ imports JAX or the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` is the port), no path names the JAX
package's benchmark folder, and the reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from gpubench.tests.tiny import REPO

FILES = sorted((REPO / "gpubench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    old = "benchmarks" + "/"   # two constants, so that this file does not name it
    assert not [s for s in strings if old in s]


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "gpubench" / "reference").rglob("*.py"):
        assert "repro_torch" not in imported(path), path


def test_the_top_level_names_are_compared_whole():
    from gpubench.run import FORBIDDEN as AT_RUN, forbidden_modules

    assert AT_RUN == FORBIDDEN
    assert "repro_torch" not in forbidden_modules()
