"""scripts/torch_rectangle_twin.py against scripts/rectangle_twin.py (the
JAX package's twin, imported by path), on the CPU at float64.

``run_episode`` at seed 0, assisted for 0.1 s (20 ticks, 2 replayer updates)
and unassisted for 0.05 s: both twins draw with the replayer's host
mt19937, so they are fed the same noise without a hook. The JAX side's
plant step is wrapped to record the EE position it returns and the wrench
it takes (its episode keeps neither); the port's ``run_episode(trace=True)``
returns both. Also: the replayer's configuration equals the JAX script's.

The JAX script's forecast-node evaluator (``kalman_nodes``, jitted) runs
unjitted here. Jitted, XLA on the CPU (jax 0.9.0) fuses its
``concatenate`` into the vmapped interpolation and returns the cached
horizon's row 30 for node 29, where the forecast's own query gives row 29
(unjitted, or jitted without the concatenate); the port's twin queries the
forecast node by node and gives row 29.

Tolerance: |port - jax| <= 1e-8 * max(|jax|, 1) on the EE trace, the force
magnitudes and the summary's mean and max force.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.rectangle_twin as jax_twin  # noqa: E402
import scripts.torch_rectangle_twin as twin  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8


def close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0), err_msg=label)


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX script's jitted rollout, filter and plant step, built once:
    run_episode builds the same pure functions anew per call."""
    return jax_twin.build_episode_fns()


def jax_run(monkeypatch, jax_fns, seed, duration, assisted):
    """The JAX twin's run_episode with its plant step recorded: (summary,
    EE trace, force magnitudes)."""
    ees, forces = [], []

    def recording_build():
        batched, filtered, plant_step, nodes = jax_fns

        def step(x, u, wrench, dt):
            x_next, ee = plant_step(x, u, wrench, dt)
            ees.append(np.asarray(ee, np.float64))
            forces.append(float(np.linalg.norm(np.asarray(wrench, np.float64)[:3])))
            return x_next, ee

        return batched, filtered, step, nodes

    monkeypatch.setattr(jax_twin, "build_episode_fns", recording_build)
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda fn, *args, **kwargs: fn if fn.__name__ == "kalman_nodes"
                        else jit(fn, *args, **kwargs))
    return jax_twin.run_episode(seed, duration, assisted=assisted), np.asarray(ees), np.asarray(forces)


@pytest.mark.parametrize("assisted,duration", [(True, 0.1), (False, 0.05)], ids=["assisted", "unassisted"])
def test_run_episode_matches_jax(monkeypatch, jax_fns, assisted, duration):
    want, want_ee, want_forces = jax_run(monkeypatch, jax_fns, 0, duration, assisted)
    got = twin.run_episode(0, duration, assisted, device="cpu", trace=True)
    close(got["ee"], want_ee, "EE trace")
    close(got["forces"], want_forces, "force magnitudes")
    for key in ("mean_force", "max_force"):
        close(got[key], want[key], key)


def test_replayer_configuration_matches_jax():
    """The JAX script builds its ReplayerConfig inline; its fields as the
    script passes them (scripts/rectangle_twin.py:224-238)."""
    from assistedmanipulation_tpu.models import frankaridgeback as jax_fr

    got = dataclasses.asdict(twin.replayer_configuration())
    want = dict(
        rollouts=50, keep_best_rollouts=20, time_step=0.01, horizon=0.3, gradient_step=2.0, cost_scale=10.0,
        cost_discount_factor=1.0, covariance=np.diag(np.asarray(jax_fr.DEFAULT_COVARIANCE)),
        control_min=np.asarray(jax_fr.DEFAULT_CONTROL_MIN, np.float64),
        control_max=np.asarray(jax_fr.DEFAULT_CONTROL_MAX, np.float64), control_bound=True,
        smoothing_window=10, smoothing_order=1,
    )
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


def test_cuda_is_asked_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main(["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
