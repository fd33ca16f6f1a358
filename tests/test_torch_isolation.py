"""The port stands alone: no module of evossearch_tpu_torch, nor
chip_smoke.py, imports JAX, the JAX package, or the third-party modules
the GPU machine is not known to have (``regex``, ``ml_dtypes``, ``orbax``,
which imports JAX), and none
names the JAX package's native source directory or its built extension
(the port builds its own copy of the C++ source)."""

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
