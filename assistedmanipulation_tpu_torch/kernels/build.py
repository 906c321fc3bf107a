"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<digest>.so

``<digest>`` hashes the source, every header ``csrc/*.cuh`` (the kernels
share their step body through ``franka_step.cuh``; ``sample_rollout.cuh``
holds the in-kernel-RNG kernel's template, ``pipeline.cuh`` the fused
kernel's rings and ``philox.cuh`` the in-kernel generator) and the flags, so an edited source or header never
loads a stale library. The build directory is ``build/kernels/`` at the root
of the checkout (listed in .gitignore); ptxas's register and spill report
for each library lands beside it as ``.ptxas.txt``. Building needs nvcc and
an sm_90a card; without nvcc it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("fused_sample_rollout", "rollout", "inkernel_rng_sample_rollout", "fp32_chain", "admm_qp")
# Kernel launches by library: the tracer's registry (``tracing.LAUNCHES``,
# the same dict), which counts whether or not the tracer is on; read by
# chip_smoke.py. Each wrapper counts where it launches (``count_launch``);
# a capture tallies its kernel nodes (``capture_tally``) and each replay adds
# the tally (graphs.CapturedGraph).
LAUNCHES = tracing.LAUNCHES
LAUNCHES.update({name: 0 for name in KERNEL_SOURCES})
count_launch = tracing.count_launch
capture_tally = tracing.capture_tally
reset_launch_counts = tracing.reset_launch_counts

_lock = threading.Lock()
_libraries: dict = {}
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ptxas said about the library's kernels: registers, spills."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every named source that is not built yet, all nvcc processes
    started together. Returns {name: seconds spent building} (0 if cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC / f"{name}.cu")]
        started[name] = (
            subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            partial,
            target,
            time.perf_counter(),
        )
    failures = []
    for name, (process, partial, target, t0) in started.items():
        output, _ = process.communicate()
        build_seconds[name] = time.perf_counter() - t0
        tracing.count("kernel.build")
        if process.returncode != 0:
            failures.append(f"{name}:\n{output}")
            continue
        target.with_suffix(".ptxas.txt").write_text(output)
        os.replace(partial, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return {name: build_seconds[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libraries:
            build((name,))
            _libraries[name] = ctypes.CDLL(str(library_path(name)))
        return _libraries[name]
