"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program."""

import ast
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("evossearch_tpu_torch", "evossearch_tpu_torch.engine", "jaxtyping_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "evossearch_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["evossearch_tpu", "jaxlib"]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_no_module_of_the_benchmark_imports_jax_or_bench():
    for path in ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, name)
            assert not name.startswith("evossearch_tpu_torch.bench"), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("evossearch_tpu_torch", "portbench"), (path, name)
