"""scripts/torch_pose_dither_sweep.py against scripts/pose_dither_sweep.py
(the JAX package's sweep, imported by path).

- every row's episode: the JAX script's ``run_cell`` builds its episode
  with a recording stand-in for the JAX ``Episode`` (nothing runs), and the
  port's ``make_cell_episode`` must be built from the same planner
  configuration, episode configuration, forecast and hold point, with the
  same ``FRICTION_EPS`` in force while it is built, and the port's restored
  afterwards (the JAX script restores it after a run; its stand-in
  raises before one, so the test restores the JAX value);
- the ``eps_0.0001`` row's episode at float64 for 0.1 s (20 ticks, 2
  updates) at 10 rollouts (keep-best 4), built from each package's
  ``Episode`` with ``FRICTION_EPS`` set on both sides while it is built and
  run, both fed the same sampled noise (the JAX planner through a wrapper
  of its ``_update_impl``, the port through ``Episode.run(noise_override=)``);
  the port starts from the JAX carry;
- the row grid and the metrics of ``cell_metrics``.

Tolerances: the hold point (FK at float32 in the port, at the tests'
float64 in the JAX script) within 1e-6 m;
the episode |port - jax| <= 1e-8 * max(|jax|, 1) per output.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.pose_dither_sweep as jax_sweep  # noqa: E402
import scripts.torch_pose_dither_sweep as sweep  # noqa: E402
from assistedmanipulation_tpu.models import dynamics as jax_dyn  # noqa: E402
from assistedmanipulation_tpu.sim import episode as jax_episode  # noqa: E402
from assistedmanipulation_tpu_torch import interop  # noqa: E402
from assistedmanipulation_tpu_torch.models import dynamics as dyn  # noqa: E402
from assistedmanipulation_tpu_torch.sim import trajectories  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8
ROWS = dict(sweep.sweeps("all"))
JAX_ONLY_FIELDS = {"rng_impl", "rollout_axis"}


class Built(Exception):
    """Raised by the recording Episode once it has its arguments."""


def jax_build(monkeypatch, overrides):
    """The arguments the JAX script's run_cell builds its Episode with, and
    the JAX FRICTION_EPS in force then."""
    record = {}

    def recording_episode(*args, **kwargs):
        record.update(args=args, kwargs=kwargs, eps=jax_dyn.FRICTION_EPS)
        raise Built

    monkeypatch.setattr(jax_episode, "Episode", recording_episode)
    default_eps = jax_dyn.FRICTION_EPS
    try:
        with pytest.raises(Built):
            jax_sweep.run_cell(overrides, 15.0, 0)
    finally:
        jax_dyn.FRICTION_EPS = default_eps
    return record


def test_row_grid():
    """The JAX script's main: default, covariance x{0.5, 0.25, 0.1, 0.05},
    gradient step {1, 0.5, 0.25}, SG window {5, 15, 20}, keep-best
    {10, 35, 50}, then friction eps {1e-3, 1e-4, 1e-5}
    (scripts/pose_dither_sweep.py:156-177)."""
    assert list(ROWS) == [
        "default", "cov_x0.5", "cov_x0.25", "cov_x0.1", "cov_x0.05", "grad_1.0", "grad_0.5", "grad_0.25",
        "sg_5", "sg_15", "sg_20", "keep_10", "keep_35", "keep_50", "eps_0.001", "eps_0.0001", "eps_1e-05",
    ]
    assert [name for name, _ in sweep.sweeps("knobs")] == list(ROWS)[:14]
    assert [name for name, _ in sweep.sweeps("eps")] == list(ROWS)[14:]


@pytest.mark.parametrize("name", list(ROWS))
def test_row_episode_matches_jax(monkeypatch, name):
    overrides = ROWS[name]
    default_eps = jax_dyn.FRICTION_EPS
    record = jax_build(monkeypatch, overrides)
    assert jax_dyn.FRICTION_EPS == default_eps == dyn.FRICTION_EPS
    configuration, _, trajectory, episode_configuration = record["args"]
    assert record["eps"] == overrides.get("friction_eps", default_eps)

    with sweep.friction_eps(overrides.get("friction_eps")):
        assert dyn.FRICTION_EPS == record["eps"]
        port = sweep.make_cell_episode(overrides, 15.0, device="cpu")
    assert dyn.FRICTION_EPS == default_eps

    got, want = port.planner.configuration, configuration
    assert {f.name for f in dataclasses.fields(want)} - {f.name for f in dataclasses.fields(got)} == JAX_ONLY_FIELDS
    for field in dataclasses.fields(got):
        value, expected = getattr(got, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(expected):
            assert dataclasses.asdict(value) == dataclasses.asdict(expected), field.name
        else:
            np.testing.assert_array_equal(np.asarray(value), np.asarray(expected), err_msg=field.name)
    assert dataclasses.asdict(port.episode) == dataclasses.asdict(episode_configuration)
    assert dataclasses.asdict(port.wrench_strategy.configuration) == dataclasses.asdict(
        record["kwargs"]["wrench_strategy"].configuration)
    np.testing.assert_allclose(port.trajectory.position(torch.tensor(0.0, dtype=torch.float64)).double().numpy(),
                               np.asarray(trajectory.position(jnp.asarray(0.0)), np.float64), rtol=0, atol=1e-6)


def close(port, want, what):
    port, want = port.detach().cpu().numpy(), np.asarray(want, np.float64)
    assert port.shape == want.shape, what
    err = np.abs(port - want)
    assert (err <= TOL * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


def test_eps_row_episode_matches_jax(monkeypatch):
    """The eps_0.0001 row at 10 rollouts, float64, 0.1 s, the same noise."""
    overrides = ROWS["eps_0.0001"]
    record = jax_build(monkeypatch, overrides)
    monkeypatch.undo()
    jax_configuration, objective, trajectory, episode_configuration = record["args"]
    small = dict(rollouts=10, keep_best_rollouts=4, dtype="float64")
    episode_configuration = dataclasses.replace(episode_configuration, duration=0.1)
    default_eps = jax_dyn.FRICTION_EPS
    try:
        jax_dyn.FRICTION_EPS = overrides["friction_eps"]
        ep = jax_episode.Episode(dataclasses.replace(jax_configuration, **small), objective, trajectory,
                                 episode_configuration, wrench_strategy=record["kwargs"]["wrench_strategy"],
                                 dtype=jnp.float64)
        stack = np.random.default_rng(14).standard_normal((2, 10, ep.planner.steps, 12)) * np.sqrt(
            np.asarray(jax_configuration.covariance))
        update = ep.planner._update_impl

        def injected(state, x0, time, ctx=None, noise_override=None):
            return update(state, x0, time, ctx, noise_override=jnp.asarray(stack)[state.update_count])

        ep.planner._update_impl = injected
        carry = ep.init_carry(0)
        want = jax.device_get(ep._run(carry))
    finally:
        jax_dyn.FRICTION_EPS = default_eps

    with sweep.friction_eps(overrides["friction_eps"]):
        port = sweep.make_cell_episode(overrides, 0.1, device="cpu", dtype=torch.float64)
        port.planner = type(port.planner)(
            dataclasses.replace(port.planner.configuration, **small), port.planner.plant, device="cpu")
        # The JAX script's hold point is FK at the test's float64, the
        # port's at float32 (1e-7 m apart): both hold the JAX point here.
        point = tuple(float(v) for v in np.asarray(trajectory.position(jnp.asarray(0.0))))
        port.trajectory = trajectories.PointTrajectory(trajectories.PointConfiguration(point=point))
        port_carry = interop.episode_carry_from_numpy(jax.device_get(carry), port.planner.rollout_count,
                                                      device="cpu", dtype=torch.float64)
        got = port.run(carry=port_carry, noise_override=stack)
    assert dyn.FRICTION_EPS == default_eps
    for field in got._fields:
        close(getattr(got, field), getattr(want, field), field)
    metrics = sweep.cell_metrics(got)
    assert set(metrics) == {"mean_force", "tail_mean_force", "tail_dither_rms_m"}
    assert np.isfinite(list(metrics.values())).all()


def test_cuda_is_asked_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
