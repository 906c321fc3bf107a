"""What the benchmark's modules import: no module under portbench/ imports
JAX or the JAX package (compared by whole top-level name, since the port's
name begins with the JAX package's), and the reference imports nothing of
the program either."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = [p for p in SOURCES if "reference" in p.relative_to(ROOT / "portbench").parts[:1]]
FORBIDDEN = {"jax", "jaxlib", "flax", "assistedmanipulation_tpu"}
PROGRAM = "assistedmanipulation_tpu_torch"


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "portbench/run.py" in names and "portbench/reference/update.py" in names
    assert len(REFERENCE) >= 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_by_whole_top_level_name(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_the_port_is_not_mistaken_for_the_jax_package():
    assert PROGRAM.split(".")[0] not in FORBIDDEN and PROGRAM.startswith("assistedmanipulation_tpu")


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    imported = set(_top_level_imports(path))
    assert PROGRAM not in imported and "portbench" not in imported, imported
    assert imported <= {"__future__", "dataclasses", "functools", "importlib", "json", "math", "os", "typing", "numpy", "torch"}


def test_a_loaded_jax_module_is_found_by_its_top_level_name(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    assert set(harness.FORBIDDEN_MODULES) == FORBIDDEN
    monkeypatch.setitem(sys.modules, "assistedmanipulation_tpu_torch.mppi", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "assistedmanipulation_tpu.mppi", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_forbidden() == ["assistedmanipulation_tpu", "jax"]
