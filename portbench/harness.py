"""One run of one benchmark cell (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``).

Everything that belongs to one cell is found by name:

- ``BENCHMARK.json`` (the root of the checkout): the cell's end-to-end and
  per-layer metrics, with their units;
- ``portbench/workloads/<cell>.json``: the configuration, the traffic mix,
  the entry the cell drives, and the cell's own numbers: warm-up cycles,
  traced cycles, the updates compared and the limits they are held to;
- ``portbench/configs/<config>.json``: the deployment's sizes;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, read by the
  loop of the cell's entry, ``portbench/traffic/<entry>.py``;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader.

A run builds the entry and warms it (set-up), measures ``--seconds`` of
closed-loop cycles (``--trace 1``: the first traced cycles under
``torch.profiler``, and per-layer metrics in place of end-to-end ones),
reads the device's peak memory, frees the program, and compares the
updates drawn from the seed with the plain reference."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.reference import compare

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# Top-level modules that must not be loaded in the process that prints a
# result: JAX, and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "assistedmanipulation_tpu")


def read_json(path: Path) -> dict:
    with open(path) as handle:
        return json.load(handle)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell's files, found by the names in ``BENCHMARK.json``."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = read_json(root / "BENCHMARK.json")
        entries = {entry["name"]: entry for entry in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json ({sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        self.workload = read_json(HERE / "workloads" / f"{name}.json")
        self.config = read_json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = read_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.loop = load_module(HERE / "traffic" / f"{self.workload['entry']}.py")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py")


def sample_cycles(seed: int, workload: dict, seconds: float, first: int) -> list:
    """The window's cycles whose updates are compared, drawn from the seed
    among those every sound run reaches (``min_rate_hz`` x ``seconds``)."""
    reach = max(first + 1, int(seconds * float(workload["min_rate_hz"])))
    count = min(int(workload["compared_updates"]), reach - first)
    return sorted(random.Random(seed).sample(range(first, reach), count))


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def run(cell: Cell, seed: int, seconds: float, trace: bool, started: float, device="cuda",
        capture: bool = True, config=None) -> dict:
    """One run; returns the result line's fields and the compared numbers.
    ``device``, ``capture`` and ``config`` are for the CPU tests, which
    drive the rest of a run without the card at a tiny size."""
    config = config or cell.config
    workload = cell.workload
    on_card = torch.device(device).type == "cuda"
    loop = cell.loop.Loop(config, cell.traffic, seed, seconds, device, capture)
    start_before = loop.snapshot()
    controls = [loop.cycle()]
    samples = [(0, start_before, loop.snapshot())]
    for _ in range(int(workload["warm_cycles"])):
        controls.append(loop.cycle())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    first = loop.k
    traced = int(workload["trace_cycles"]) if trace else 0
    compared = set(sample_cycles(seed, workload, seconds, first + traced))
    # What set-up built lives on: keep the collector from walking it again
    # in the window (cycles the window makes are still collected).
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started

    latencies, prof, trace_window = [], None, 0.0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.start()
        t0 = time.perf_counter()
        for _ in range(traced):
            with record_function("portbench.issue"):
                loop.issue()
            with record_function("portbench.control_read"):
                controls.append(loop.read())
        trace_window = time.perf_counter() - t0
        prof.stop()
    window_start = time.perf_counter()
    deadline = window_start + seconds
    while time.perf_counter() < deadline and loop.cycles_left > 0:
        k = loop.k
        before = loop.snapshot() if k in compared else None
        issued = time.perf_counter()
        controls.append(loop.cycle())
        latencies.append(time.perf_counter() - issued)
        if before is not None:
            samples.append((k, before, loop.snapshot()))
    window_s = time.perf_counter() - window_start
    gc.unfreeze()
    if on_card:
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated()
    else:
        memory_peak = 0
    attempted = len(latencies) + (traced if trace else 0)
    failed = sum(1 for control in controls[-attempted:] if not np.all(np.isfinite(control))) if attempted else 0
    loop.close()
    del loop

    readings = cell.loop.check(config, cell.traffic, seed, samples, device)
    out = {
        "attempted": attempted,
        "failed": failed,
        "compared": [k for k, _, _ in samples],
        "numbers": compare.worst(readings),
        "setup_s": setup_s,
        "memory_peak_bytes": memory_peak,
    }
    if trace:
        from portbench import trace as trace_module

        summary = trace_module.from_profiler(prof, traced, trace_window, config)
        out["trace"] = summary
        out["breakdown"] = trace_module.breakdown(summary)
    else:
        out["solves_per_s"] = len(latencies) / window_s
        out["update_ms_p95"] = 1e3 * statistics.quantiles(latencies, n=20, method="inclusive")[-1]
        out["latency_samples"] = len(latencies)
    return out


def verdict(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit
    (a limit of 0 asks for 0), no failed cycle."""
    rows = [(name, float(numbers[name]), float(limits[name])) for name in limits]
    correct = failed == 0 and all(not math.isnan(value) and value <= limit for _, value, limit in rows)
    return correct, rows
