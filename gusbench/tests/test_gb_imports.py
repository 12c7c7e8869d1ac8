"""Nothing under gusbench imports JAX or the JAX package ``repro``
(compared by the whole top-level name, so ``repro_torch`` is not
``repro``), and nothing reads ``benchmarks/``."""
import ast
import sys
from pathlib import Path

from harness import runner

BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _top_level_imports(path) & set(runner.FORBIDDEN)
        assert not found, f"{path}: {found}"
        if path.name != "test_gb_imports.py":
            assert "benchmarks/" not in path.read_text(), path


def test_only_the_system_module_imports_the_program():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts or path.name == "run.py":
            continue
        if "repro_torch" in _top_level_imports(path):
            assert path == BENCH / "systems" / "dynamic_gus.py", path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in runner.forbidden_modules()
