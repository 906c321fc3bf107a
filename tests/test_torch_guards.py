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
- By name: every public function and class a JAX module defines at its top
  level has a counterpart of that name in its port module, and every field
  of its dataclasses and NamedTuples a field of the port's class, except
  the names ``NAME_LEAVE_OUT`` lists (each must stand in the leave-out
  list) and the ones ``NAMES_PORTED_AS`` maps to the port's own name.
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
# Names of the JAX package with no counterpart of that name in the port, by
# module; ROADMAP.md's leave-out list gives each one's reason.
NAME_LEAVE_OUT = {
    "mppi.py": ("Configuration.rng_impl", "Configuration.rollout_axis"),
    "kernels/pallas_rollout.py": ("make_pallas_planner", "max_sublanes_for_vmem"),
}
# Names the port took another name for: (module, JAX name) -> the port's.
NAMES_PORTED_AS = {
    ("kernels/pallas_rollout.py", "PallasSampler"): "CudaSampler",
    ("kernels/pallas_rollout.py", "make_pallas_rollout_fn"): "make_cuda_rollout_fn",
    ("kernels/pallas_rollout.py", "lane_noise_assemble"): "assemble_noise",
}


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


def _public_names(path):
    """{name: fields or None} of the public functions and classes a module
    defines at its top level; the fields of a dataclass or NamedTuple."""
    tree = ast.parse(open(path).read(), filename=path)
    names = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
            continue
        fields = None
        if isinstance(node, ast.ClassDef):
            decorators = [ast.unparse(d) for d in node.decorator_list]
            if any("dataclass" in d for d in decorators) or any(ast.unparse(b) == "NamedTuple" for b in node.bases):
                fields = [
                    statement.target.id for statement in node.body
                    if isinstance(statement, ast.AnnAssign) and isinstance(statement.target, ast.Name)
                ]
        names[node.name] = fields
    return names


def _missing_names():
    missing = {}
    for module in _modules(JAX_PACKAGE):
        port_module = os.path.join(PORT, PORTED_AS.get(module, module))
        if not os.path.exists(port_module):
            continue  # a module left out whole (test_every_jax_module_has_a_port)
        jax_names, port_names = _public_names(os.path.join(JAX_PACKAGE, module)), _public_names(port_module)
        gaps = []
        for name, fields in jax_names.items():
            port_name = NAMES_PORTED_AS.get((module, name), name)
            if port_name not in port_names:
                gaps.append(name)
            elif fields and port_names[port_name] is not None:
                gaps += [f"{name}.{field}" for field in fields if field not in port_names[port_name]]
        if gaps:
            missing[module] = tuple(gaps)
    return missing


def test_every_public_name_has_a_port():
    missing = _missing_names()
    assert {module: set(names) for module, names in missing.items()} == {
        module: set(names) for module, names in NAME_LEAVE_OUT.items()
    }, missing


def test_renamed_ports_exist():
    for (module, name), port_name in NAMES_PORTED_AS.items():
        assert name in _public_names(os.path.join(JAX_PACKAGE, module)), name
        assert port_name in _public_names(os.path.join(PORT, PORTED_AS.get(module, module))), port_name


def test_name_leave_out_list_stands_in_the_roadmap():
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    leave_out = roadmap[roadmap.index("**Leave out of the port:**"):]
    leave_out = leave_out[:leave_out.index("\n### ")]
    for names in NAME_LEAVE_OUT.values():
        for name in names:
            assert f"`{name.split('.')[-1]}`" in leave_out, name
    for (_, name), port_name in NAMES_PORTED_AS.items():
        assert f"`{name}`" in leave_out and f"`{port_name}`" in leave_out, name
