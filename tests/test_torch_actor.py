"""The port's Actor against the JAX package's, at float64 on the CPU.

40 host-loop ticks of the circle experiment (rollouts 10, keep-best 4, a
0.1 s horizon, the 20 Hz controller: 4 updates): each tick the human PID
pulls the end effector toward the circle from the current state's
end-effector position, the wrench goes to ``add_end_effector_wrench`` and
the actor acts. Both planners' ``update`` are wrapped to pass the same
sampled noise (``noise_override``). On the JAX side the loop's plant
step, aux and PID update are wrapped in ``jax.jit``, and so is the
dynamics forecast, with the strategy state as an argument: run eagerly it
compiles anew at every update (its wrench query closes over the strategy
state), which is what makes a JAX host loop slow on a CPU.

Checked: per tick the state, the control and the forecast context within
|port - jax| <= 1e-8 * max(|jax|, 1); then each package's Episode (the
episode engine) against its own Actor loop under the same noise, tick by
tick, to the same tolerance: the two engines agree in both packages when
the loop's human model reads the current state. Two differences of the
JAX code that these runs avoid, kept by the port: the actor honours
``forecast_rate`` (with a rate > 0 it feeds the strategy at that rate and
runs prediction-only ticks between), while the episode observes every
tick; and the harness's host engine computes the human wrench from
``actor.aux``, the previous tick's pre-step aux, so its trees differ from
the episode engine's by one tick of human-model lag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.objectives.assisted_manipulation import AssistedManipulation as JaxObjective
from assistedmanipulation_tpu.sim import actor as jax_actor
from assistedmanipulation_tpu.sim import episode as jax_episode
from assistedmanipulation_tpu.sim import pid as jax_pid
from assistedmanipulation_tpu.sim import trajectories as jax_trajectories
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation
from assistedmanipulation_tpu_torch.sim import actor, episode, pid, trajectories
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8
DT = 0.005
TICKS = 40
ROLLOUTS, KEEP, HORIZON = 10, 4, 0.1


def close(port, want, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want, dtype=np.float64)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    err = np.abs(port - want)
    assert (err <= TOL * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


def configuration(package):
    cfg = package.Configuration()
    cfg.mppi = dataclasses.replace(cfg.mppi, rollouts=ROLLOUTS, keep_best_rollouts=KEEP, horizon=HORIZON,
                                   dtype="float64")
    return cfg


def noise():
    scale = np.sqrt(np.asarray(actor.Configuration().mppi.covariance))
    steps = int(np.ceil(HORIZON / 0.01))
    return np.random.default_rng(3).standard_normal((TICKS // 10, ROLLOUTS, steps, 12)) * scale


def inject(planner, stack):
    update = planner.update

    def injected(state, x, time, ctx=None):
        return update(state, x, time, ctx, noise_override=stack[int(state.update_count)])

    planner.update = injected


def jax_loop():
    """The JAX actor's host loop: per tick (x, control, ctx horizon, ctx
    start time)."""
    a = jax_actor.Actor(configuration(jax_actor), DT, dtype=jnp.float64)
    inject(a.planner, jnp.asarray(noise()))
    forecast = a.dynamics_forecast.forecast
    strategy = a.wrench_forecast
    jitted = jax.jit(lambda x, time, state: forecast(x, time, lambda t: strategy.forecast(state, t)))
    a.dynamics_forecast.forecast = lambda x, time, wrench_at: jitted(
        x, jnp.asarray(time, jnp.float64), a.forecast_state
    )
    a.plant_step = jax.jit(a.plant_step, static_argnums=3)
    human = jax_pid.PID(jax_pid.HUMAN_POINT_CONTROL)
    human_state = human.init(jnp.float64)
    circle = jax_trajectories.CircularTrajectory(jax_trajectories.CircularConfiguration())

    @jax.jit
    def human_update(state, x, t):
        state = human.set_reference(state, circle.position(t))
        return human.update(state, jax_fr.derive_aux(a.model, x).ee_position, t)

    rows = []
    for i in range(TICKS):
        t = i * DT
        human_state = human_update(human_state, a.x, jnp.asarray(t, jnp.float64))
        a.add_end_effector_wrench(jnp.concatenate([human_state.control, jnp.zeros(3)]), t)
        a.act(t)
        rows.append(jax.device_get((a.x, a.control, a.ctx.wrench_horizon, a.ctx.start_time)))
    return rows


def port_loop():
    a = actor.Actor(configuration(actor), DT, dtype=torch.float64, device="cpu")
    inject(a.planner, torch.as_tensor(noise()))
    human = pid.PID(pid.HUMAN_POINT_CONTROL)
    human_state = human.init(torch.float64, "cpu")
    circle = trajectories.CircularTrajectory(trajectories.CircularConfiguration())
    rows = []
    for i in range(TICKS):
        t = torch.tensor(i * DT, dtype=torch.float64)
        aux = fr.derive_aux(a.model, a.x)
        human_state = human.set_reference(human_state, circle.position(t))
        human_state = human.update(human_state, aux.ee_position, t)
        a.add_end_effector_wrench(torch.cat([human_state.control, torch.zeros(3, dtype=torch.float64)]), i * DT)
        a.act(i * DT)
        rows.append((a.x, a.control, a.ctx.wrench_horizon, a.ctx.start_time))
    return rows


@pytest.fixture(scope="module")
def jax_rows():
    return jax_loop()


@pytest.fixture(scope="module")
def port_rows():
    return port_loop()


def test_actor_matches_jax(jax_rows, port_rows):
    names = ("x", "control", "ctx.wrench_horizon", "ctx.start_time")
    for tick, (got, want) in enumerate(zip(port_rows, jax_rows)):
        for name, g, w in zip(names, got, want):
            close(g, w, f"tick {tick}: {name}")


def test_episode_engine_agrees_with_the_actor_loop(jax_rows, port_rows):
    """Each package's episode against its own actor loop: the state before
    each tick (the episode logs it; the loop's row i holds the state after
    tick i) and the control."""
    jax_ep = jax_episode.Episode(
        configuration(jax_actor).mppi, JaxObjective(),
        jax_trajectories.CircularTrajectory(jax_trajectories.CircularConfiguration()),
        jax_episode.EpisodeConfiguration(duration=TICKS * DT), dtype=jnp.float64, collect_logs=True,
    )
    stack = jnp.asarray(noise())
    update = jax_ep.planner._update_impl
    jax_ep.planner._update_impl = lambda state, x0, time, ctx=None, noise_override=None: update(
        state, x0, time, ctx, noise_override=stack[state.update_count]
    )
    jax_outputs, jax_logs = jax.device_get(jax_ep.run(0))
    port_ep = episode.Episode(
        configuration(actor).mppi, AssistedManipulation(),
        trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
        episode.EpisodeConfiguration(duration=TICKS * DT), dtype=torch.float64, collect_logs=True, device="cpu",
    )
    port_outputs, port_logs = port_ep.run(0, noise_override=noise())
    for logs, outputs, rows, package in (
        (jax_logs, jax_outputs, jax_rows, "jax"), (port_logs, port_outputs, port_rows, "port"),
    ):
        states = np.stack([np.asarray(row[0]) for row in rows])
        controls = np.stack([np.asarray(row[1]) for row in rows])
        close(np.asarray(logs.x)[1:], states[:-1], f"{package}: episode states vs actor loop")
        close(np.asarray(outputs.control), controls, f"{package}: episode controls vs actor loop")
