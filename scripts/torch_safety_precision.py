#!/usr/bin/env python3
"""The port's safety filter at float32 against float64, on the CPU.

    python3 scripts/torch_safety_precision.py [--out FILE]

Runs ``safety.make_safety_filter`` at both precisions on the same inputs:
the four binding cases of tests/test_torch_safety.py (one limit enabled,
a state and control where it binds) and the default filter (all four
limits) on each of those four inputs. The filtered control of each
precision then goes through the float64 plant step (``make_plant_step``),
and each limit's violation is read off the next state: the velocity and
position boxes on v+ and q+, the acceleration box on (v+ - v) / dt, the
reach sphere on |p_ee(q+) - mount(q+)|. The filter's QP is a fixed number
of ADMM iterations, the reach row is linearised, and the default filter's
four limits can contradict each other (a joint too close to its bound to
stop within the acceleration box), so float64 leaves a violation of its
own: that is the filter's tolerance. A float32 row that breaks its limit
by more than float64 does, beyond float32's rounding at the limit's scale,
is a fault. Prints one JSON line
per case: each limit's violation at both precisions, the float32 one's
excess over the float64 one relative to max(|bound|, float64 violation,
1) (``excess_rel``), the largest
|u_float32 - u_float64| and the same relative to max(|u_float64|), and the
filter's move |u_float64 - u|.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from assistedmanipulation_tpu_torch import safety  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models import kinematics as kin  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402

LIMITS = ("limit_velocity", "limit_joints", "limit_acceleration", "limit_reach")


def binding_cases() -> dict:
    """tests/test_torch_safety.py::_binding_cases: (options, state,
    control) where the named limit binds, then the default filter on each
    of the same four inputs."""
    slam = np.array([0.5, 0.5, 1.0, 87, 87, 87, 87, 12, 12, 12, 0, 0], dtype=np.float64)
    huddled = fr.make_state("huddled")
    near_joint = huddled.copy()
    near_joint[6] = -0.001
    near_joint[18] = 0.5
    reach = fr.make_state("reach")
    only = {name: False for name in LIMITS}
    inputs = {
        "velocity": ({**only, "limit_velocity": True}, huddled, slam),
        "acceleration": ({**only, "limit_acceleration": True}, huddled, slam),
        "joints": ({**only, "limit_joints": True}, near_joint, np.zeros(12)),
        "reach": ({**only, "limit_reach": True}, reach, np.zeros(12)),
    }
    cases = dict(inputs)
    for name, (_, x, u) in inputs.items():
        cases[f"default/{name}"] = ({}, x, u)
    return cases


def violations(x: np.ndarray, u: torch.Tensor, cfg: safety.Configuration) -> dict:
    """Each limit's largest violation after one float64 plant step from
    ``x`` under ``u`` (0 where it holds), over every limit (enabled or not:
    the caller picks)."""
    model = frankaridgeback_model()
    x64 = torch.tensor(x, dtype=torch.float64)
    step = fr.make_plant_step(model=model)
    x1, _ = step(x64, u.double(), torch.zeros(6, dtype=torch.float64), cfg.time_step)
    pos_min, pos_max, vel_min, vel_max, acc_min, acc_max = (torch.tensor(a) for a in cfg.resolve())
    q1, v1, v0 = x1[fr.POSITION], x1[fr.VELOCITY], x64[fr.VELOCITY]
    acc = (v1 - v0) / cfg.time_step

    def beyond(value, low, high):
        return float(torch.clamp(torch.maximum(value - high, low - value), min=0.0).max())

    fk = kin.forward_kinematics(model, q1)
    _, p_ee = kin.frame_transform(model, fk, model.end_effector_frame)
    _, mount = kin.frame_transform(model, fk, "arm_mount_joint")
    reach = torch.linalg.vector_norm(p_ee - mount)
    return {
        "limit_velocity": beyond(v1, vel_min, vel_max),
        "limit_joints": beyond(q1, pos_min, pos_max),
        "limit_acceleration": beyond(acc, acc_min, acc_max),
        "limit_reach": beyond(reach[None], torch.tensor([cfg.reach_minimum], dtype=torch.float64),
                              torch.tensor([cfg.reach_maximum], dtype=torch.float64)),
    }


def limit_scales(cfg: safety.Configuration) -> dict:
    """The largest |bound| of each limit: the scale a violation is read
    against."""
    pos_min, pos_max, vel_min, vel_max, acc_min, acc_max = cfg.resolve()

    def largest(*bounds):
        return float(max(np.abs(b).max() for b in bounds))

    return {
        "limit_velocity": largest(vel_min, vel_max),
        "limit_joints": largest(pos_min, pos_max),
        "limit_acceleration": largest(acc_min, acc_max),
        "limit_reach": largest(cfg.reach_minimum, cfg.reach_maximum),
    }


def measure(options: dict, x: np.ndarray, u: np.ndarray) -> dict:
    """One case at both precisions: the filtered controls and each enabled
    limit's violation after the plant step."""
    cfg = safety.Configuration(**options)
    filter_fn = safety.make_safety_filter(cfg)
    out = {}
    for dtype in (torch.float64, torch.float32):
        out[dtype] = filter_fn(torch.tensor(x, dtype=dtype), torch.tensor(u, dtype=dtype), 0.0)
    enabled = [name for name in LIMITS if getattr(cfg, name)]
    by_dtype = {str(dtype).removeprefix("torch."): violations(x, filtered, cfg) for dtype, filtered in out.items()}
    u64, u32 = out[torch.float64], out[torch.float32].double()
    scale = limit_scales(cfg)
    excess = {name: (by_dtype["float32"][name] - by_dtype["float64"][name])
              / max(scale[name], by_dtype["float64"][name], 1.0) for name in enabled}
    return {
        "limits": enabled,
        "violation": {dtype: {name: v[name] for name in enabled} for dtype, v in by_dtype.items()},
        "excess_rel": excess,
        "control_max_abs_diff": float((u32 - u64).abs().max()),
        "control_max_rel_diff": float((u32 - u64).abs().max() / torch.clamp(u64.abs().max(), min=1.0)),
        "filter_move": float((u64 - torch.tensor(u)).abs().max()),
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="also write the lines to this JSON file")
    args = parser.parse_args()
    torch.set_num_threads(1)
    lines = []
    for name, (options, x, u) in binding_cases().items():
        line = {"case": name, **measure(options, x, u)}
        print(json.dumps(line))
        lines.append(line)
    if args.out:
        Path(args.out).write_text(json.dumps(lines, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
