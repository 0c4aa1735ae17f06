import ast
from pathlib import Path

import pytest

from benchmark.harness import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & {*FORBIDDEN, "merfish3d_tpu_torch", "benchmark"}
    assert names <= {"__future__", "contextlib", "dataclasses", "itertools", "json", "math", "random",
                     "typing", "collections", "numpy", "scipy", "torch"}


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "merfish3d_tpu_torch_like", types.ModuleType("x"))
    assert "merfish3d_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "merfish3d_tpu.utils", types.ModuleType("x"))
    assert "merfish3d_tpu" in forbidden_modules()
