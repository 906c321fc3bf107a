"""Test harness: name registry, CLI, timestamped output folders (port of
assistedmanipulation_tpu/harness/runner.py).

Re-implements the reference L5 harness (src/test/test.hpp:23-261,
main.cpp:102-158):

- tests self-register under a name (RegisteredTest static-init pattern ->
  a decorator here);
- CLI: ``-l`` lists tests; ``--test <name> --out <dir> [--config <json>]``
  runs one, with the JSON config merge-patched onto the test's defaults;
- every run writes ``<out>/<name>_<datetime>/`` with the fully-resolved
  configuration.json (base.cpp:88-96) and the CSV logging tree;
- wall-clock timing and progress output (test.hpp:180-212);
- ``--resume <run_folder>`` continues an interrupted host-engine run from
  its checkpoint.npz (enable snapshots with ``--config
  '{"checkpoint_interval": N}'``).

``--device`` picks the device (``cuda`` by default; ``cpu`` runs the plain
PyTorch path on the CPU). Without a CUDA device, ``cuda`` raises: nothing
falls back to the CPU.

Run: ``python -m assistedmanipulation_tpu_torch.harness --test circle --out runs``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time as time_module

from .. import resolve_device

_REGISTRY: dict = {}


def register_test(name: str):
    """Class decorator: register a test case under ``name``
    (test.hpp:233-261)."""

    def wrap(cls):
        cls.TEST_NAME = name
        _REGISTRY[name] = cls
        return cls

    return wrap


class TestSuite:
    @staticmethod
    def names():
        return sorted(_REGISTRY)

    @staticmethod
    def run(name: str, out: str, patch: dict = None, duration: float = None, device="cuda") -> bool:
        """Create and run a registered test (test.hpp:134-215) on
        ``device``."""
        if name not in _REGISTRY:
            print(f"unknown test {name!r}; available: {TestSuite.names()}", file=sys.stderr)
            return False
        device = resolve_device(device)

        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        folder = os.path.join(out, f"{name}_{stamp}")
        os.makedirs(folder, exist_ok=True)

        test = _REGISTRY[name](folder=folder, patch=patch or {}, duration=duration, device=device)

        # Dump the fully-resolved configuration (base.cpp:88-96).
        try:
            from .. import config as cfg

            with open(os.path.join(folder, "configuration.json"), "w") as handle:
                json.dump(cfg.to_json(test.configuration), handle, indent=2, default=str)
        except Exception as error:  # config dump must never kill the run
            print(f"configuration dump failed: {error}", file=sys.stderr)

        print(f"running test {name!r} on {device} -> {folder}")
        start = time_module.perf_counter()
        try:
            ok = test.run()
        finally:
            if hasattr(test, "close"):
                test.close()
        elapsed = time_module.perf_counter() - start
        print(f"test {name!r} {'passed' if ok else 'FAILED'} in {elapsed:.1f}s")
        return ok

    @staticmethod
    def resume(run_folder: str, device="cuda") -> bool:
        """Continue an interrupted run from its checkpoint.npz on
        ``device``: the test class comes from the checkpoint's metadata,
        the configuration from the folder's configuration.json; the CSV
        tree truncates to the snapshot and continues in append mode."""
        from .. import checkpoint as checkpoint_module

        path = os.path.join(run_folder, "checkpoint.npz")
        if not os.path.exists(path):
            print(f"no checkpoint.npz in {run_folder}", file=sys.stderr)
            return False
        name = checkpoint_module.load_metadata(path)["test"]
        if name not in _REGISTRY:
            print(f"unknown test {name!r} in checkpoint", file=sys.stderr)
            return False
        test = _REGISTRY[name].resume(run_folder, device=resolve_device(device))
        print(f"resuming test {name!r} in {run_folder} on {test.device} from t={test.time:.3f}s "
              f"(tick {test._start_tick})")
        start = time_module.perf_counter()
        try:
            ok = test.run()
        finally:
            if hasattr(test, "close"):
                test.close()
        elapsed = time_module.perf_counter() - start
        print(f"test {name!r} {'passed' if ok else 'FAILED'} in {elapsed:.1f}s")
        return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="assistedmanipulation_tpu_torch.harness",
        description="MPPI experiment harness (PyTorch/CUDA port)",
    )
    parser.add_argument("-l", "--list", action="store_true", help="list tests")
    parser.add_argument("--test", help="test name to run")
    parser.add_argument(
        "--resume",
        metavar="RUN_FOLDER",
        help="continue an interrupted run from its checkpoint.npz "
        "(enable snapshots with --config '{\"checkpoint_interval\": N}')",
    )
    parser.add_argument("--out", default="runs", help="output directory")
    parser.add_argument("--config", help="JSON merge-patch onto the defaults")
    parser.add_argument("--duration", type=float, help="override duration [s]")
    parser.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="device to run on (default cuda; raises without one, nothing falls back to the CPU)",
    )
    args = parser.parse_args(argv)

    if args.list:
        for name in TestSuite.names():
            print(name)
        return 0

    if args.resume:
        return 0 if TestSuite.resume(args.resume, device=args.device) else 1

    if not args.test:
        parser.print_help()
        return 1

    patch = json.loads(args.config) if args.config else {}
    ok = TestSuite.run(args.test, args.out, patch, args.duration, device=args.device)
    return 0 if ok else 1
