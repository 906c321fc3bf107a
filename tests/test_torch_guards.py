"""Guards of the port's boundary, by reading its sources (no import).

- No module of assistedmanipulation_tpu_torch/, nor chip_smoke.py, nor a
  scripts/torch_*.py imports ``jax`` (or ``jaxlib``) or the JAX package
  ``assistedmanipulation_tpu``: the port keeps its own copies of what it
  needs, and the machine with the card has no JAX.
- Every module of the JAX package has its counterpart in the port at the
  same relative path, except the ones ROADMAP.md's "Leave out of the port"
  list names (each must stand there) and the one whose port took another
  name (the Pallas sampler, ported as the CUDA one). ``NEXT_SLICE`` names
  modules still to port: none.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "assistedmanipulation_tpu_torch")
JAX_PACKAGE = os.path.join(ROOT, "assistedmanipulation_tpu")
FORBIDDEN = ("jax", "jaxlib", "assistedmanipulation_tpu")

LEAVE_OUT = ("cache.py", "ops/flops.py")
PORTED_AS = {"kernels/pallas_rollout.py": "kernels/cuda_rollout.py"}
NEXT_SLICE = ()


def _port_sources():
    sources = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    sources += [os.path.join(ROOT, "chip_smoke.py")] + glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    return sorted(os.path.relpath(path, ROOT) for path in sources)


def _imported(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_are_found():
    sources = _port_sources()
    assert "chip_smoke.py" in sources and os.path.join("scripts", "torch_parity_replay.py") in sources
    assert os.path.join("assistedmanipulation_tpu_torch", "harness", "sweep.py") in sources


@pytest.mark.parametrize("path", _port_sources())
def test_port_imports_no_jax(path):
    bad = [name for name in _imported(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _modules(package):
    return sorted(
        os.path.relpath(path, package).replace(os.sep, "/")
        for path in glob.glob(os.path.join(package, "**", "*.py"), recursive=True)
    )


def test_every_jax_module_has_a_port():
    port = set(_modules(PORT))
    missing = [m for m in _modules(JAX_PACKAGE) if PORTED_AS.get(m, m) not in port]
    assert sorted(missing) == sorted(LEAVE_OUT + NEXT_SLICE), missing


def test_leave_out_list_stands_in_the_roadmap():
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    leave_out = roadmap[roadmap.index("**Leave out of the port:**"):]
    for module in LEAVE_OUT + ("_fastlog",):
        assert f"`{module}`" in leave_out, module
