"""Where chip_smoke.py's wall goes: ``chip_smoke.main()`` with a timer
around each of its helpers.

Usage (on the card; it runs the whole smoke test):
    python3 scripts/torch_smoke_timings.py OUT_DIR

Writes OUT_DIR/timings.json: one [helper, start s since the start, seconds]
per call, nested calls each counted (``drive_both`` holds its
``drive_flagship`` calls, which hold their ``profile_steps``). The
smoke's own ``phase N done, X s since the start`` lines give each call's
phase. Exits with the smoke's code.
"""

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

EVENTS = []
START = time.perf_counter()
HELPERS = (
    "compare", "compare_scenarios", "check_scenarios_bitwise", "timed_call", "time_call", "check_planner_against_cpu",
    "check_inkernel_planner_against_cpu", "drive_flagship", "drive_both", "check_captured_against_eager",
    "profile_steps", "time_graph", "check_safe_velocity", "kalman_serving_loop", "start_cli", "finish_cli",
    "circle_episode", "tree_bitwise", "check_tree", "check_inkernel", "distribution_gate", "kernel_inputs",
    "rollout_kernel_inputs", "inkernel_inputs", "check_twin_against_unsharded", "bitwise_equal", "csv_tree_bytes",
    "surface_phase", "covariance_gate",
)


def timed(name, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            EVENTS.append((name, round(start - START, 2), round(time.perf_counter() - start, 3)))

    return inner


def main(out: str) -> int:
    from assistedmanipulation_tpu_torch import graphs
    from assistedmanipulation_tpu_torch.harness.runner import TestSuite
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.sim import episode

    for name in HELPERS:
        setattr(chip_smoke, name, timed(name, getattr(chip_smoke, name)))
    graphs.CapturedGraph.__init__ = timed("CapturedGraph.__init__", graphs.CapturedGraph.__init__)
    episode.Episode.run = timed("Episode.run", episode.Episode.run)
    episode.Episode._capture_period = timed("Episode._capture_period", episode.Episode._capture_period)
    TestSuite.run = staticmethod(timed("TestSuite.run", TestSuite.run))
    TestSuite.resume = staticmethod(timed("TestSuite.resume", TestSuite.resume))
    for name in ("fused_sample_rollout_reference", "rollout_reference", "inkernel_rng_sample_rollout_reference"):
        setattr(cuda_rollout, name, timed(name, getattr(cuda_rollout, name)))
    os.makedirs(out, exist_ok=True)
    try:
        return chip_smoke.main()
    finally:
        with open(os.path.join(out, "timings.json"), "w") as handle:
            json.dump(EVENTS, handle)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
