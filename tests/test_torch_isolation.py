"""The port stands alone: no module of evossearch_tpu_torch, nor
chip_smoke.py, imports JAX, the JAX package, or the third-party modules
the GPU machine is not known to have (``regex``, ``ml_dtypes``, ``orbax``,
which imports JAX), and none
names the JAX package's native source directory or its built extension
(the port builds its own copy of the C++ source).

The test files that ``chip_smoke.py``'s ``reference_suites`` phase runs
on a GPU machine without JAX (its ``REFERENCE_SUITES``) must collect
there: none imports a forbidden module at module level. An import inside
a test body (the JAX package as the oracle of a ``cpu`` case) is
allowed."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "evossearch_tpu", "regex",
             "ml_dtypes")
FILES = sorted(
    p for p in (ROOT / "evossearch_tpu_torch").rglob("*.py")
    if "_build" not in p.parts  # kernel build outputs, not the package
) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_scans_the_whole_port():
    assert len(FILES) > 20
    assert ROOT / "evossearch_tpu_torch" / "engine.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = {
        name for name in _imports(path)
        if name.split(".")[0] in FORBIDDEN
    }
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_native_paths(path):
    text = path.read_text()
    for needle in ("native/", "evossearch_tpu/_native", "build.sh"):
        assert needle not in text, f"{path.relative_to(ROOT)} names {needle!r}"


def _reference_suites() -> list[Path]:
    """chip_smoke.py's REFERENCE_SUITES, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "REFERENCE_SUITES" for t in node.targets):
            return [ROOT / p for p in ast.literal_eval(node.value)]
    raise AssertionError("chip_smoke.py defines no REFERENCE_SUITES")


def _module_level_imports(path: Path) -> set[str]:
    """Modules imported when ``path`` is imported: every import outside a
    function body (class bodies and conditional blocks included)."""
    names = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names.update(alias.name for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                names.add(child.module)
            visit(child)

    visit(ast.parse(path.read_text(), filename=str(path)))
    return names


def test_reference_suites_are_listed():
    suites = _reference_suites()
    assert len(suites) >= 6 and all(p.is_file() for p in suites), suites
    assert all(p.name.startswith("test_torch_ref_") for p in suites), suites


@pytest.mark.parametrize("path", _reference_suites(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_suites_collect_without_jax(path):
    bad = {
        name for name in _module_level_imports(path)
        if name.split(".")[0] in FORBIDDEN
    }
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)} at module level"


def test_module_level_scan_skips_test_bodies(tmp_path):
    src = tmp_path / "t.py"
    src.write_text("import numpy\nclass A:\n    import jax\n"
                   "def test_x():\n    import evossearch_tpu\n")
    assert _module_level_imports(src) == {"numpy", "jax"}
