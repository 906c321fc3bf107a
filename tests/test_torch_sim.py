"""The port's simulation host pieces against the JAX package's, at float64
on the CPU: the trajectory generators, the human-model PIDs and the
configuration system.

- Every position and orientation generator, through the factories, at
  seeded times (a batch and a 0-d tensor): |port - jax| <= 1e-12 * max(|jax|, 1).
- PID and QuaternionPID over a seeded observation sequence that saturates
  (anti-windup holds the integral) and repeats a time stamp (a stale
  update), from the first-update bootstrap: every PIDState field per step
  within the same 1e-12.
- config: merge-patch semantics (None deletes, dicts merge, the rest
  replaces), the reference's "horison" key, numpy-array fields coerced;
  and ``to_json`` of the port's default actor, episode and harness
  configurations equal to the JAX package's trees, less the JAX mppi
  configuration's TPU-only keys (``rng_impl``, ``rollout_axis``,
  ``elite_select``), which the port does not have.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu import config as jax_config
from assistedmanipulation_tpu.harness import cases as jax_cases
from assistedmanipulation_tpu.sim import actor as jax_actor
from assistedmanipulation_tpu.sim import episode as jax_episode
from assistedmanipulation_tpu.sim import pid as jax_pid
from assistedmanipulation_tpu.sim import trajectories as jax_trajectories
from assistedmanipulation_tpu_torch import config
from assistedmanipulation_tpu_torch.harness import cases
from assistedmanipulation_tpu_torch.sim import actor, episode, pid, trajectories

TOL = 1e-12
JAX_ONLY_MPPI_KEYS = ("rng_impl", "rollout_axis", "elite_select")


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    err = np.abs(got - want.astype(np.float64))
    assert (err <= TOL * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


POSITIONS = [
    {"type": "point", "point": {"point": [0.5, -0.2, 1.3]}},
    {"type": "circle"},
    {"type": "circle", "circle": {"axis": [1.0, 0.0, 0.0], "radius": 0.4, "angular_velocity": 2.0}},
    {"type": "rectangle", "rectangle": {"width": 0.8, "height": 0.5, "velocity": 0.7, "axis": [0.0, 1.0, 1.0]}},
    {"type": "lissajous"},
    {"type": "figure_eight"},
]
ORIENTATIONS = [
    {"type": "axis_angle", "axis_angle": {"axis": [1.0, 1.0, 0.0], "angle": 0.7}},
    {"type": "slerp", "slerp": {"first_angle": 0.3, "second_axis": [0.0, 1.0, 0.0], "second_angle": 1.1}},
    {"type": "slerp"},
]
TIMES = np.random.default_rng(1).uniform(0.0, 12.0, 64)


@pytest.mark.parametrize("kind,tree", [("position", p) for p in POSITIONS] + [("orientation", o) for o in ORIENTATIONS])
def test_trajectories_match_jax(kind, tree):
    if kind == "position":
        jax_cfg = jax_config.from_json(jax_trajectories.PositionConfiguration, tree)
        port_cfg = config.from_json(trajectories.PositionConfiguration, tree)
        want = jax_trajectories.create_position(jax_cfg).position
        got = trajectories.create_position(port_cfg).position
    else:
        jax_cfg = jax_config.from_json(jax_trajectories.OrientationConfiguration, tree)
        port_cfg = config.from_json(trajectories.OrientationConfiguration, tree)
        want = jax_trajectories.create_orientation(jax_cfg).orientation
        got = trajectories.create_orientation(port_cfg).orientation
    close(got(torch.tensor(TIMES)), want(jnp.asarray(TIMES)), f"{tree} batch")
    close(got(torch.tensor(TIMES[3])), want(jnp.asarray(TIMES[3])), f"{tree} 0-d")


def observations():
    """(time, observation) pairs: a large step error (saturates at +-100),
    small ones (the integral runs), a repeated time stamp (stale)."""
    rng = np.random.default_rng(2)
    times = np.cumsum(np.full(24, 0.005))
    times[9] = times[8]  # stale: no time advance
    values = rng.normal(0.0, 0.05, (24, 3))
    values[4:7] += np.array([1.0, -2.0, 0.5])  # kp * 1 m = 300 N: saturated
    return times, values


@pytest.mark.parametrize("quaternion", [False, True])
def test_pid_matches_jax(quaternion):
    times, values = observations()
    if quaternion:
        jax_controller = jax_pid.QuaternionPID(jax_pid.HUMAN_ORIENTATION_CONTROL)
        controller = pid.QuaternionPID(pid.HUMAN_ORIENTATION_CONTROL)
    else:
        jax_controller = jax_pid.PID(jax_pid.HUMAN_POINT_CONTROL)
        controller = pid.PID(pid.HUMAN_POINT_CONTROL)
    jax_state = jax_controller.init(jnp.float64)
    state = controller.init(torch.float64, "cpu")
    reference = np.array([0.9, 0.1, 1.2])
    reference_quat = np.array([np.cos(0.4), np.sin(0.4), 0.0, 0.0])
    saturated = 0
    for step, (t, value) in enumerate(zip(times, values)):
        if quaternion:
            angle = np.linalg.norm(value)
            axis = value / angle
            observed = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
            jax_state = jax_controller.update_quaternion(jax_state, jnp.asarray(observed), jnp.asarray(reference_quat), t)
            state = controller.update_quaternion(state, torch.tensor(observed), torch.tensor(reference_quat),
                                                 torch.tensor(t))
        else:
            jax_state = jax_controller.set_reference(jax_state, reference)
            jax_state = jax_controller.update(jax_state, jnp.asarray(reference + value - 0.1), t)
            state = controller.set_reference(state, torch.tensor(reference))
            state = controller.update(state, torch.tensor(reference + value - 0.1), t)
        for field in state._fields:
            close(getattr(state, field), getattr(jax_state, field), f"step {step}: {field}")
        saturated += int(state.saturation.sum())
    assert quaternion or saturated > 0


def test_merge_patch_semantics():
    target = {"a": 1, "b": {"c": 2, "d": [1, 2]}, "e": "x"}
    patch = {"a": None, "b": {"c": 3, "d": [5]}, "f": {"g": None, "h": 1}, "e": {"y": 2}}
    assert config.merge_patch(target, patch) == jax_config.merge_patch(target, patch)
    assert config.merge_patch(target, patch) == {"b": {"c": 3, "d": [5]}, "e": {"y": 2}, "f": {"h": 1}}
    assert config.merge_patch(target, 5) == 5
    tree = {"mppi": {"rollouts": 7, "horison": 0.2, "covariance": [1.0] * 12}, "unknown": 3, "forecast": None}
    port = config.patched(actor.Configuration(), tree)
    want = jax_config.patched(jax_actor.Configuration(), tree)
    assert port.mppi.rollouts == want.mppi.rollouts == 7
    assert port.mppi.horizon == want.mppi.horizon == 0.2
    assert isinstance(port.mppi.covariance, np.ndarray) and port.mppi.covariance.dtype == np.float64
    # None deletes the key, and the default comes back: merge-patch cannot
    # disable the optional forecast (pose.hpp:50-60), hence forecast.enabled.
    assert port.forecast.enabled and want.forecast.enabled
    assert config.loads(actor.Configuration, '{"controller_rate": 0.1}').controller_rate == 0.1


def without_jax_only_keys(tree):
    if isinstance(tree, dict):
        return {
            key: without_jax_only_keys(value) for key, value in tree.items()
            if not (key in JAX_ONLY_MPPI_KEYS and "keep_best_rollouts" in tree)
        }
    if isinstance(tree, list):
        return [without_jax_only_keys(value) for value in tree]
    return tree


@pytest.mark.parametrize("name", ["actor", "episode", "harness"])
def test_default_configurations_match_jax(name):
    port, want = {
        "actor": (actor.Configuration(), jax_actor.Configuration()),
        "episode": (episode.EpisodeConfiguration(), jax_episode.EpisodeConfiguration()),
        "harness": (cases.ExternalWrenchConfiguration(), jax_cases.ExternalWrenchConfiguration()),
    }[name]
    assert config.to_json(port) == without_jax_only_keys(jax_config.to_json(want))
    round_trip = config.from_json(type(port), config.to_json(port))
    assert config.to_json(round_trip) == config.to_json(port)
    assert dataclasses.is_dataclass(round_trip)
