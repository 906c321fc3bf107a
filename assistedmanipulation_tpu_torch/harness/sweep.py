"""Cartesian parameter sweep over any registered test (port of
assistedmanipulation_tpu/harness/sweep.py).

The reference shipped this unfinished — ``ParameterSweep`` addressed config
leaves by JSON pointer with (minimum, maximum, step) ranges but did not
compile and was excluded from the build (src/test/case/parameter_sweep.hpp:
12-36, parameter_sweep.cpp:33-49, CMakeLists.txt:49). This is the working
version: each parameter is a JSON pointer plus either an explicit ``values``
list or a (minimum, maximum, step) range; the cartesian product of all
parameters runs the inner test once per combination in its own subfolder and
a ``sweep.csv`` summarizes pass/fail + wall time per combination. Every
combination runs on the sweep's device.

Run:
    python -m assistedmanipulation_tpu_torch.harness --test parameter_sweep \
        --out runs --config '{"test": "reach", "duration": 1.0,
            "parameters": [{"pointer": "/actor/mppi/cost_scale",
                            "values": [5.0, 10.0]}]}'
"""

from __future__ import annotations

import itertools
import json
import os
import time as walltime

import numpy as np

from .. import config as cfg
from ..logging.csv_logger import CSVWriter
from .runner import _REGISTRY, register_test


def pointer_to_patch(pointer: str, value):
    """RFC 6901 JSON pointer -> nested merge-patch dict
    (parameter_sweep.hpp:12-20 addressed leaves the same way)."""
    keys = [k.replace("~1", "/").replace("~0", "~") for k in pointer.split("/")[1:]]
    if not keys:
        raise ValueError(f"invalid JSON pointer {pointer!r}")
    patch = value
    for key in reversed(keys):
        patch = {key: patch}
    return patch


def parameter_values(parameter: dict):
    """Either an explicit ``values`` list or a min/max/step range
    (parameter_sweep.hpp Parameter{pointer, minimum, maximum, step})."""
    if "values" in parameter:
        return list(parameter["values"])
    minimum = float(parameter["minimum"])
    maximum = float(parameter["maximum"])
    step = float(parameter["step"])
    count = int(np.floor((maximum - minimum) / step + 1e-9)) + 1
    return [minimum + i * step for i in range(count)]


@register_test("parameter_sweep")
class ParameterSweepTest:
    """Cartesian sweep harness (the finished version of the reference's
    excluded parameter_sweep test)."""

    DEFAULT_CONFIGURATION = {
        "test": "reach",
        "duration": 1.0,
        "parameters": [
            {"pointer": "/actor/mppi/cost_scale", "values": [5.0, 10.0]},
            {"pointer": "/actor/mppi/gradient_step", "values": [1.0, 2.0]},
        ],
    }

    def __init__(self, folder: str, patch: dict = None, duration: float = None, device="cuda"):
        self.configuration = dict(self.DEFAULT_CONFIGURATION)
        self.configuration.update(patch or {})
        if duration is not None:
            self.configuration["duration"] = duration
        self.folder = folder
        self.device = device

    def run(self) -> bool:
        inner_name = self.configuration["test"]
        if inner_name not in _REGISTRY or inner_name == "parameter_sweep":
            print(f"parameter_sweep: unknown inner test {inner_name!r}")
            return False
        inner_cls = _REGISTRY[inner_name]
        parameters = self.configuration["parameters"]
        pointers = [p["pointer"] for p in parameters]
        grids = [parameter_values(p) for p in parameters]

        summary = CSVWriter(
            os.path.join(self.folder, "sweep.csv"),
            ["index"] + [p.strip("/").replace("/", ".") for p in pointers]
            + ["passed", "wall_time"],
        )
        ok = True
        for index, combo in enumerate(itertools.product(*grids)):
            patch: dict = {}
            for pointer, value in zip(pointers, combo):
                patch = cfg.merge_patch(patch, pointer_to_patch(pointer, value))
            subfolder = os.path.join(self.folder, f"combo_{index:03d}")
            os.makedirs(subfolder, exist_ok=True)
            with open(os.path.join(subfolder, "parameters.json"), "w") as f:
                json.dump(dict(zip(pointers, combo)), f, indent=2)

            test = inner_cls(
                folder=subfolder,
                patch=patch,
                duration=self.configuration["duration"],
                device=self.device,
            )
            start = walltime.perf_counter()
            try:
                passed = test.run()
            finally:
                if hasattr(test, "close"):
                    test.close()
            elapsed = walltime.perf_counter() - start
            summary.write(index, list(combo), int(passed), round(elapsed, 3))
            print(f"  combo {index}: {dict(zip(pointers, combo))} -> "
                  f"{'ok' if passed else 'FAILED'} ({elapsed:.1f}s)")
            ok = ok and passed
        summary.close()
        return ok

    def close(self):
        pass
