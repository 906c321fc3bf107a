"""scripts/torch_force_offset_sweep.py against the JAX package's episode as
scripts/force_offset_sweep.py builds it (its ``run`` is local to ``main``,
so the test builds the JAX Episode with the arguments ``run`` passes:
scripts/force_offset_sweep.py:69-90).

The controller-off episode for 0.1 s (20 ticks) at float64 on the CPU with
a friction-scaled model (0.5) on the circle and with the (500, 10)
differential gains on the rectangle: no planner runs, so no noise is
needed. Also: the script's gain vector and scaled model equal the JAX
script's, and the study grid.

Tolerance: |port - jax| <= 1e-9 * max(|jax|, 1) per output.
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

import scripts.experiments as jax_ex  # noqa: E402
import scripts.torch_force_offset_sweep as sweep  # noqa: E402
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr  # noqa: E402
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model  # noqa: E402
from assistedmanipulation_tpu.objectives.assisted_manipulation import AssistedManipulation as JaxObjective  # noqa: E402
from assistedmanipulation_tpu.sim import episode as jax_episode  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-9
DURATION = 0.1
CASES = {
    "friction_0.5_circle": ("circle", {"friction_scale": 0.5}),
    "gains_500_10_rectangle": ("rectangle", {"gains": (500.0, 10.0)}),
}


def jax_options(spec):
    """The model and robot configuration the JAX script's studies pass."""
    if "friction_scale" in spec:
        base = jax_model()
        return {"model": dataclasses.replace(base, friction=base.friction * spec["friction_scale"])}
    base_kd, arm_kd = spec["gains"]
    kd = np.array([base_kd] * 3 + [arm_kd] * 7 + [50.0, 50.0])
    kp = np.array([0.0] * 10 + [100.0, 100.0])
    return {"robot_cfg": jax_fr.Configuration(proportional_gain=kp, differential_gain=kd)}


def port_options(spec):
    if "friction_scale" in spec:
        return {"model": sweep.scaled_friction_model(spec["friction_scale"])}
    return {"robot_configuration": sweep.gains_configuration(*spec["gains"])}


def test_grid_and_plant_options_match_jax():
    assert sweep.STUDIES == ("friction", "gains", "controller", "seeds")
    assert sweep.FRICTION_SCALES == (1.0, 0.5, 0.25, 0.0)
    assert sweep.GAINS == ((1000.0, 10.0), (500.0, 10.0), (250.0, 10.0), (1000.0, 5.0))
    for base_kd, arm_kd in sweep.GAINS:
        got = sweep.gains_configuration(base_kd, arm_kd)
        want = jax_options({"gains": (base_kd, arm_kd)})["robot_cfg"]
        for name in ("proportional_gain", "differential_gain"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for scale in sweep.FRICTION_SCALES:
        np.testing.assert_array_equal(sweep.scaled_friction_model(scale).friction,
                                      jax_options({"friction_scale": scale})["model"].friction)


@pytest.mark.parametrize("case", list(CASES))
def test_controller_off_episode_matches_jax(case):
    trajectory, spec = CASES[case]
    options = jax_options(spec)
    ep = jax_episode.Episode(
        dataclasses.replace(jax_ex.mppi_configuration(), dtype="float64"),
        JaxObjective(),
        jax_ex.make_trajectory(trajectory),
        jax_episode.EpisodeConfiguration(
            duration=DURATION, time_step=0.005, controller_rate=0.05, forecast_time_step=0.01,
            forecast_horizon=0.3, assisted=False, controller_enabled=False,
        ),
        wrench_strategy=None,
        robot_configuration=options.get("robot_cfg"),
        model=options.get("model"),
        dtype=jnp.float64,
    )
    want = jax.device_get(ep.run(seed=0))
    port = sweep.make_episode(trajectory, DURATION, device="cpu", dtype=torch.float64, **port_options(spec))
    got = port.run(seed=0)
    for field in got._fields:
        value, expected = getattr(got, field).numpy(), np.asarray(getattr(want, field), np.float64)
        assert value.shape == expected.shape, field
        err = np.abs(value - expected)
        assert (err <= TOL * np.maximum(np.abs(expected), 1.0)).all(), (field, float(err.max()))
    # The plant moved under the human's drag, and the metrics are finite.
    assert (got.ee_position[-1] - got.ee_position[0]).abs().max().item() > 1e-6
    assert np.isfinite(list(sweep.ex.episode_metrics(got).values())).all()


def test_cuda_is_asked_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
