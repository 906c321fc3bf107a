#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port ``assistedmanipulation_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards. The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each compared number with its limit, which also close
standard error. Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits with 3. Kernel builds are cached under
``build/`` in the checkout (``build/kernels`` for the port's nvcc
libraries), so only a checkout's first run of a cell builds.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache a build or a compiler might write stays in the checkout, at a
# fixed path.
for variable, folder in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                         ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(variable, str(ROOT / "build" / folder))
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as error:
        return f"nvidia-smi unavailable: {error}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import importlib.util

    import torch

    from portbench import harness

    # One process, one host thread of PyTorch's own: the loop's host work is
    # launches and one read, and idle pool threads only compete for cores.
    torch.set_num_threads(1)

    if importlib.util.find_spec("assistedmanipulation_tpu_torch") is None:
        print(f"portbench: the program under test, assistedmanipulation_tpu_torch, is not in {ROOT}",
              file=sys.stderr)
        return 5

    cell = harness.Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has {count}. "
              "The benchmark measures the card and never falls back to the CPU.", file=sys.stderr)
        return 3
    print(f"portbench: card {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), STARTED)
    if args.trace:
        metrics = {}
        for metric in cell.per_layer:
            value = cell.reader(metric["name"]).read(result["trace"])
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        print(f"portbench: launch calls per cycle {result['trace'].launch_calls()}", file=sys.stderr)
    else:
        measured = {"solves_per_s": result["solves_per_s"], "update_ms_p95": result["update_ms_p95"],
                    "setup_s": result["setup_s"]}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        print(f"portbench: {result['latency_samples']} cycles timed in the window", file=sys.stderr)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": result["memory_peak_bytes"],
    }
    if args.trace:
        device["busy_s"] = result["trace"].busy_s()
        device["window_s"] = result["trace"].window_s
    correct, rows = harness.verdict(result["numbers"], cell.workload["limits"], result["failed"])

    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"portbench: the run loaded {forbidden}; the port runs without JAX", file=sys.stderr)
        return 4
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(f"portbench: updates compared {result['compared']}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
