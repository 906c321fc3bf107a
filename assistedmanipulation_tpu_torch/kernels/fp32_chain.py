"""FP32 issue-peak probe: the counterpart of scripts/vpu_roofline.py's
``_chain_kernel``, ``build_chain`` and ``measure_rate`` (vpu_roofline.py:
56-174), on the hand-written kernel of csrc/fp32_chain.cu.

``chain`` launches the kernel for a CUDA tensor (or raises) and takes the
plain version ``chain_reference`` for a CPU tensor. ``measure_rate`` keeps
the script's K-vs-4K method: back-to-back launches timed with CUDA events
at K and 4K iterations; the difference cancels the launch cost.
``loop_instruction_counts`` reads the built library's SASS and counts the
FFMA and FADD instructions in each instantiation's loop, which must be
accumulators x unroll: nothing folded or reassociated (``check_sass``).
``check_chain`` holds the kernel to its plain version: the add leg bitwise
(a fault that drops adds moves the output by whole ulps), the FMA leg
within FMA_RTOL. ``probe`` is the measurement from start to end, which
chip_smoke.py and scripts/torch_fp32_roofline.py both call: the SASS check,
both legs at every accumulator count while a thread reads the SM clock, the
peaks beside the nominal rate, and given kernels' share of them.

The script chained its launches (each consumed the previous output) only
to order them on the TPU's runtime; one CUDA stream orders them. Chaining
would also leave the data the probe is meant to run on: the chain's map
x -> mean of the accumulators has no stable point near 1 once there are
two or more accumulators (their start offsets 0.001 a lift the mean above
1, and then c = 0.9999999 x exceeds 1), so a float32 evaluation of it
overflows to inf by the second chained launch of the FMA leg, and a unit
that multiplies inf (or 0) draws less power than one on live data. Every
launch here reads the same input, all 1.0, on which the accumulators stay
between 1 and 1.031 over the 4 x 2,048 iterations of the longest launch.

Element count: the TPU script's 16 tiles of 8 x 128 are 16,384 elements,
128 blocks of 128 threads on an H100, which would leave 4 of its 132 SMs
idle. The port's default, ``default_elements``, is 2,048 per SM (270,336 on
an H100): blocks of 1,024 threads, two per SM, so every SM holds the same
work in whole waves whether two blocks fit at once or one, and each of an
SM's 4 schedulers has 16 warps to hide the FMA latency.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from . import build

CHOICES = (1, 2, 4, 8, 16)  # accumulator counts and unrolls compiled in
UNROLL = 16  # vpu_roofline.py's default
ITERATIONS = 2048  # K of the K-vs-4K difference, vpu_roofline.py's default
REPS = 30  # back-to-back launches per timing
BLOCKS = 5  # timings per loop length; the rate takes the best
ELEMENTS_PER_SM = 2048
CHECK_ITERATIONS = 4  # K of the check against the plain version
# The FMA leg against its plain version, relative: the kernel fuses each
# step, the plain version rounds the product and the sum.
FMA_RTOL = 1e-5

_C = float(np.float32(0.9999999))
_D = float(np.float32(1e-7))
_STEP = float(np.float32(0.001))


def default_elements(device=None) -> int:
    """2,048 elements per SM of the card: whole waves on every SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count * ELEMENTS_PER_SM


def chain_reference(x: torch.Tensor, iterations: int, accumulators: int, fma: bool,
                    unroll: int = UNROLL) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same chains, the FMA leg as
    a product and a sum, each rounded (the kernel fuses them)."""
    c = x * _C
    d = x * _D
    acc = torch.stack([x + np.float32(_STEP) * np.float32(a) for a in range(accumulators)])
    for _ in range(iterations * unroll):
        acc = acc * c + d if fma else acc + d
    total = acc[0]
    for a in range(1, accumulators):
        total = total + acc[a]
    return total * float(np.float32(1.0 / accumulators))


def _library():
    lib = build.load("fp32_chain")
    if not getattr(lib, "_checked", False):
        lib.fc_launch.restype = ctypes.c_int
        lib.fc_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib._checked = True
    return lib


def chain(x: torch.Tensor, iterations: int, accumulators: int, fma: bool,
          unroll: int = UNROLL) -> torch.Tensor:
    """``accumulators`` chains of ``iterations`` x ``unroll`` dependent FMAs
    (``fma``) or adds per element of the float32 vector ``x``; returns their
    mean per element. CUDA tensors launch csrc/fp32_chain.cu; CPU tensors
    take ``chain_reference``."""
    if x.device.type == "cpu":
        return chain_reference(x, iterations, accumulators, fma, unroll)
    if x.device.type != "cuda":
        raise ValueError(f"no FP32 chain kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous vector")
    if accumulators not in CHOICES or unroll not in CHOICES:
        raise ValueError(f"accumulators and unroll must be among {CHOICES}")
    if iterations < 0:
        raise ValueError("iterations must not be negative")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().fc_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), iterations, accumulators, unroll,
            int(fma), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fp32_chain launch failed: CUDA error {err}")
    build.count_launch("fp32_chain")
    return out


def compare_to_reference(got: torch.Tensor, want: torch.Tensor, fma: bool, label: str = "") -> float:
    """Raise unless ``got`` is the chain's output ``want`` of the plain
    version: the add leg bitwise (both round every sum to nearest in the
    same order), the FMA leg within FMA_RTOL relative. Returns the largest
    absolute difference."""
    err = float((got - want).abs().max())
    if fma:
        if not bool(((got - want).abs() <= FMA_RTOL * want.abs()).all()):
            raise AssertionError(f"fp32_chain FMA leg {label}: differs from its plain version by up to {err:.3g}")
    elif not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"fp32_chain add leg {label}: not bitwise its plain version (up to {err:.3g})")
    return err


def check_chain(x: torch.Tensor, iterations: int = CHECK_ITERATIONS) -> float:
    """``chain`` against ``chain_reference`` on ``x`` at 1 and 16
    accumulators, both legs (``compare_to_reference``). Returns the largest
    absolute difference."""
    worst = 0.0
    for fma in (True, False):
        for accumulators in (1, 16):
            got = chain(x, iterations, accumulators, fma)
            want = chain_reference(x, iterations, accumulators, fma)
            label = f"(accumulators {accumulators}, K {iterations})"
            worst = max(worst, compare_to_reference(got, want, fma, label))
    return worst


def _time_launches(x: torch.Tensor, iterations: int, accumulators: int, fma: bool,
                   reps: int, blocks: int) -> float:
    """Seconds per launch: the best of ``blocks`` timings of ``reps``
    back-to-back launches each (a peak is a maximum: other work only
    slows)."""
    y = chain(x, iterations, accumulators, fma)  # warm
    best = float("inf")
    for _ in range(blocks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            y = chain(x, iterations, accumulators, fma)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"chain output not finite (accumulators {accumulators}, fma {fma})")
    return best


def measure_rate(accumulators: int, fma: bool, x: torch.Tensor, iterations: int = ITERATIONS,
                 reps: int = REPS, blocks: int = BLOCKS) -> dict:
    """FP32 instructions per second: the extra work of 4K over K iterations
    over the extra time. Returns the rate and both times per launch."""
    t1 = _time_launches(x, iterations, accumulators, fma, reps, blocks)
    t4 = _time_launches(x, 4 * iterations, accumulators, fma, reps, blocks)
    extra = x.numel() * 3 * iterations * accumulators * UNROLL
    rate = extra / (t4 - t1) if t4 > t1 else float("nan")
    return {"rate": rate, "ms_k": t1 * 1e3, "ms_4k": t4 * 1e3}


def sweep(x: torch.Tensor, iterations: int = ITERATIONS, reps: int = REPS,
          blocks: int = BLOCKS) -> dict:
    """Both legs at every accumulator count: {"fma": {A: {...}}, "add":
    {...}, "peak_fma": max rate, "peak_add": max rate}."""
    out = {}
    for leg, fma in (("fma", True), ("add", False)):
        out[leg] = {a: measure_rate(a, fma, x, iterations, reps, blocks) for a in CHOICES}
        rates = [entry["rate"] for entry in out[leg].values()]
        if not all(np.isfinite(rates)):
            raise AssertionError(f"{leg} leg: a rate is not finite: {rates}")
        out[f"peak_{leg}"] = max(rates)
    return out


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        found = "/usr/local/cuda/bin/cuobjdump"
    if found is None:
        raise RuntimeError("cuobjdump not found")
    return found


_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)|`\(([^)]+)\)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_MANGLED = re.compile(r"fp32_chain_kernelILi(\d+)ELi(\d+)ELb([01])E")


def loop_instruction_counts(sass: Optional[str] = None) -> dict:
    """{(accumulators, unroll, fma): (FFMA, FADD) in the loop body} for every
    instantiation in the built library's SASS (``cuobjdump -sass``). The
    loop body is the span of the backward branch that ends it."""
    if sass is None:
        _library()  # built first
        sass = subprocess.run(
            [_cuobjdump(), "-sass", str(build.library_path("fp32_chain"))],
            check=True, capture_output=True, text=True,
        ).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        mangled = _MANGLED.search(block.splitlines()[0])
        if mangled is None:
            continue
        key = (int(mangled.group(1)), int(mangled.group(2)), mangled.group(3) == "1")
        instructions, labels, pending = [], {}, []
        for line in block.splitlines()[1:]:
            label = _LABEL.match(line)
            if label:
                pending.append(label.group(1))
                continue
            match = _INSTRUCTION.search(line)
            if match is None:
                continue
            address = int(match.group(1), 16)
            for name in pending:
                labels[name] = address
            pending = []
            instructions.append((address, match.group(3), match.group(4)))
        loops = []
        for address, opcode, operands in instructions:
            if not opcode.startswith("BRA"):
                continue
            target = _TARGET.search(operands)
            if target is None:
                continue
            to = int(target.group(1), 16) if target.group(1) else labels.get(target.group(2))
            if to is not None and to < address:
                loops.append((to, address))
        if len(loops) != 1:
            raise AssertionError(f"{key}: expected one loop in the SASS, found {len(loops)}")
        start, end = loops[0]
        body = [opcode for address, opcode, _ in instructions if start <= address <= end]
        counts[key] = (
            sum(op.split(".")[0] == "FFMA" for op in body),
            sum(op.split(".")[0] == "FADD" for op in body),
        )
    return counts


def check_sass() -> dict:
    """Raise unless the loop of every instantiation in the built library
    holds accumulators x unroll FFMA (FMA leg) or FADD (add leg)
    instructions and nothing of the other; returns the counts."""
    counts = loop_instruction_counts()
    for (accumulators, unroll, fma), (ffma, fadd) in counts.items():
        if (ffma, fadd) != ((accumulators * unroll, 0) if fma else (0, accumulators * unroll)):
            raise AssertionError(f"SASS loop of fp32_chain<{accumulators}, {unroll}, {fma}> holds {ffma} FFMA "
                                 f"and {fadd} FADD, not {accumulators * unroll} of its leg")
    if len(counts) != 2 * len(CHOICES) ** 2:
        raise AssertionError(f"found {len(counts)} fp32_chain instantiations in the SASS")
    return counts


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def nominal_rate(device=None) -> float:
    """FP32 instructions per second on the data sheet's terms: SMs x 128
    lanes x the maximum SM clock ``nvidia-smi`` reports."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * 128 * float(_smi("clocks.max.sm")) * 1e6


class _ClockSampler(threading.Thread):
    """Reads the SM clock (MHz) every ``period`` seconds until stopped."""

    def __init__(self, period: float = 0.25):
        super().__init__(daemon=True)
        self.period, self.samples, self._done = period, [], threading.Event()

    def run(self):
        while not self._done.wait(self.period):
            self.samples.append(float(_smi("clocks.sm")))

    def stop(self) -> list:
        self._done.set()
        self.join()
        return self.samples


def probe(x: torch.Tensor, iterations: int = ITERATIONS, reps: int = REPS, blocks: int = BLOCKS,
          kernel_work: Optional[dict] = None) -> dict:
    """The FP32 issue-peak measurement: ``check_sass``, then ``sweep`` over
    ``x`` while the SM clock is read every 0.25 s. ``kernel_work`` maps a
    kernel's name to (FP32 instructions, ms) of one launch; the report gives
    each its issue rate and share of the measured FMA peak and of the
    nominal rate. Returns the report (JSON-ready)."""
    counts = check_sass()
    nominal = nominal_rate(x.device)
    sampler = _ClockSampler()
    sampler.start()
    try:
        rates = sweep(x, iterations, reps, blocks)
    finally:
        clocks = sampler.stop()
    kernels = {}
    for name, (instructions, ms) in (kernel_work or {}).items():
        rate = instructions / (ms * 1e-3)
        kernels[name] = {
            "ms": ms,
            "instructions": instructions,
            "instructions_per_s": rate,
            "share_of_measured_fma_peak": rate / rates["peak_fma"],
            "share_of_nominal": rate / nominal,
        }
    legs = ("fma", "add")
    return {
        "elements": x.numel(),
        "iterations_k": iterations,
        "unroll": UNROLL,
        "peak_fma_per_s": rates["peak_fma"],
        "peak_add_per_s": rates["peak_add"],
        "nominal_per_s": nominal,
        "peak_fma_share_of_nominal": rates["peak_fma"] / nominal,
        "peak_add_share_of_nominal": rates["peak_add"] / nominal,
        "rates_per_s": {leg: {str(a): entry["rate"] for a, entry in rates[leg].items()} for leg in legs},
        "ms_per_launch_k_4k": {
            leg: {str(a): [entry["ms_k"], entry["ms_4k"]] for a, entry in rates[leg].items()} for leg in legs
        },
        "sm_clock_mhz_during_legs": {
            "samples": len(clocks),
            "min": min(clocks) if clocks else None,
            "median": statistics.median(clocks) if clocks else None,
            "max": max(clocks) if clocks else None,
        },
        "sass_loop_ffma_fadd_a16_u16": {"fma": list(counts[16, 16, True]), "add": list(counts[16, 16, False])},
        "sass_instantiations": len(counts),
        "kernels": kernels,
    }
