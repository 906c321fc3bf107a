"""The port's lanes backend against the JAX package's, at float64 on the CPU.

- ``kernels/lanes.lane_angular_jacobian`` against JAX's on random q.
- One JAX lanes planner (``make_lanes_planner``, a module-scoped fixture;
  its configuration carries a full covariance, which a ``noise_override``
  update does not read) is the reference of:
  - ``kernels/lane_rollout.make_lanes_rollout_fn``: the (R, 2) costs and
    rollout 0's (S, 31) states that JAX's computed in its update, from the
    same noise;
  - ``make_lanes_planner`` and ``build_flagship(backend="lanes")`` fed the
    same ``noise_override``: costs, controls, rollout-0 states;
  - the port's full-covariance planner on the two-pass path (kernel 2's
    plain version through ``make_cuda_rollout_fn``, the JAX
    ``make_pallas_planner(fused_sampling=False)``, whose step body the JAX
    lanes rollout is), within the tolerance of tests/test_torch_mppi.py.
- The lanes flagship against the port's kernel path (the kernels' plain
  versions) on the same fresh draws, bitwise: both run the same lanes
  step; also with a scenario ensemble, the safety filter, the 2-shard
  twin, and in resimulate mode (there the re-rollout runs through the
  plant on the lanes backend and through kernel 2 on the kernel path:
  within 1e-9).
- ``make_lane_filter_rollout`` against JAX's and against
  ``make_cuda_filter_rollout_fn``'s plain version on one optimal sequence:
  cost (2,) and states (S, 31).

Tolerances: rtol 1e-9 (tests/test_torch_lanes.py: libm may differ in the
last ulp between XLA and PyTorch), violation counts exact.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.kernels import lane_rollout as jax_lane_rollout
from assistedmanipulation_tpu.kernels import lanes as jax_lanes
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu.parallel.flagship import default_mppi_configuration as jax_default_configuration
from assistedmanipulation_tpu_torch import mppi
from assistedmanipulation_tpu_torch.kernels import build, lane_rollout, lanes
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import (
    make_cuda_filter_rollout_fn,
    make_cuda_rollout_fn,
    noise_to_logical,
)
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    AssistedManipulation,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, default_mppi_configuration
from test_torch_full_covariance import COVARIANCE  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

DT = 0.01
STEPS, ROLLOUTS = 6, 30
R = ROLLOUTS + 2
RTOL = 1e-9
SCALE = np.sqrt(fr.DEFAULT_COVARIANCE)


def contexts():
    """A 25 N x-pull with a y-sweep, for both packages. Its end (0.095 s)
    falls between step times: XLA fuses t0 + k * dt into one FMA under jit,
    so a step time on the horizon's end could land on either side of it."""
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 25.0
    wrench[:, 1] = np.linspace(-5.0, 5.0, 11)
    return (
        ForecastContext(torch.tensor(wrench), torch.tensor(0.0, dtype=torch.float64), DT, 0.095),
        JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float64), DT, 0.095),
    )


def close(port, want, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(want, np.float64), rtol=RTOL, atol=1e-12, err_msg=what)


def test_lane_angular_jacobian_matches_jax():
    rng = np.random.default_rng(2)
    q = fr.PRESETS["huddled"][:, None] + rng.normal(0.0, 0.6, (12, 16))
    model, jmodel = frankaridgeback_model(), jax_model()
    fk = lanes.lane_fk(model, [torch.tensor(x) for x in q])
    jfk = jax_lanes.lane_fk(jmodel, [jnp.asarray(x) for x in q])
    like, jlike = torch.zeros(16, dtype=torch.float64), jnp.zeros(16)
    for body in (fr.EE_BODY, 0, 5):
        columns = lanes.lane_angular_jacobian(model, fk, body)
        jcolumns = jax_lanes.lane_angular_jacobian(jmodel, jfk, body)
        assert len(columns) == len(jcolumns) == 12
        for got, want in zip(columns, jcolumns):
            assert [c is None for c in got] == [c is None for c in want]
            if got[0] is not None:
                close(torch.stack([lanes.materialize(c, like) for c in got]),
                      np.stack([np.asarray(jax_lanes.materialize(c, jlike)) for c in want]))
    # The base's prismatic x/y joints add no angular velocity.
    assert lanes.lane_angular_jacobian(model, fk, fr.EE_BODY)[0] == [None, None, None]


@pytest.fixture(scope="module")
def jax_planner():
    cfg = dataclasses.replace(jax_default_configuration(ROLLOUTS, STEPS, rng_impl="threefry2x32"),
                              dtype="float64", covariance=COVARIANCE)
    return jax_lane_rollout.make_lanes_planner(cfg)


def port_configuration(**extra):
    return dataclasses.replace(default_mppi_configuration(ROLLOUTS, STEPS, dtype="float64"), **extra)


def test_lanes_rollout_fn_matches_jax(jax_planner):
    """The port's rollout_fn on the noise of a JAX update from the initial
    state (its shifted optimal is zero) gives the costs and rollout-0
    states JAX's computed there."""
    rng = np.random.default_rng(3)
    override = rng.standard_normal((R - 2, STEPS, 12)) * SCALE
    ctx, jctx = contexts()
    x0 = fr.make_state("huddled")
    jax_state, jax_info = jax_planner.update(jax_planner.init(seed=0), x0, 0.0, jctx, noise_override=override)
    fn = lane_rollout.make_lanes_rollout_fn(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), STEPS, DT)
    args = (torch.tensor(np.asarray(jax_state.noise)), torch.zeros((STEPS, 12), dtype=torch.float64),
            torch.tensor(x0), torch.tensor(0.0, dtype=torch.float64))
    costs, states = fn(*args, ctx)
    np.testing.assert_array_equal(costs[:, 0].numpy(), np.asarray(jax_state.costs)[:, 0])
    close(costs, jax_state.costs, "costs")
    close(states, jax_info.optimal_rollout_states, "states")
    idle, _ = fn(*args, None)
    assert (idle[:, 1] < costs[:, 1]).all()  # no forecast: no trajectory cost


def test_full_covariance_two_pass_planner_matches_jax(jax_planner):
    """The two-pass path with a non-diagonal covariance, 3 updates under the
    same noise_override: every state field and info output within rtol
    1e-10, atol 1e-12."""
    planner = mppi.Planner(
        port_configuration(covariance=COVARIANCE), fr.make_plant(AssistedManipulation()), device="cpu",
        rollout_fn=make_cuda_rollout_fn(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
                                        STEPS, DT, device="cpu"),
    )
    assert planner.sampler._factor.shape == (12, 12)
    ctx, jctx = contexts()
    x0 = fr.make_state("huddled")
    rng = np.random.default_rng(8)
    T = np.asarray(jax_planner._transform)
    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    build.reset_launch_counts()
    for time in (0.0, 0.01, 0.03):
        override = rng.standard_normal((R - 2, STEPS, 12)) @ T.T
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jctx, noise_override=override)
        state, info = planner.update(state, x0, time, ctx, noise_override=override)
        for name in ("noise", "optimal_control", "costs", "sg_buffer", "sg_time", "optimal_cost"):
            got = getattr(state, name)
            got = noise_to_logical(got) if name == "noise" else got
            np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jax_state, name)), rtol=1e-10, atol=1e-12,
                                       err_msg=name)
        for name in jax_info._fields:
            np.testing.assert_allclose(getattr(info, name).numpy(), np.asarray(getattr(jax_info, name)),
                                       rtol=1e-10, atol=1e-12, err_msg=name)
    assert all(count == 0 for count in build.LAUNCHES.values())


def test_lanes_planner_matches_jax(jax_planner):
    """``make_lanes_planner`` and ``build_flagship(backend="lanes")`` under
    the same noise_override as the JAX lanes planner, 3 updates."""
    ctx, jctx = contexts()
    x0 = fr.make_state("huddled")
    cfg = port_configuration()
    flagship = build_flagship(ROLLOUTS, STEPS, device="cpu", dtype="float64", backend="lanes")
    planners = [lane_rollout.make_lanes_planner(cfg, device="cpu"), flagship.planner]
    rng = np.random.default_rng(5)
    jax_state = jax_planner.init(seed=0)
    states = [planner.init(seed=0) for planner in planners]
    build.reset_launch_counts()
    for time in (0.0, 0.01, 0.03):
        override = rng.standard_normal((R - 2, STEPS, 12)) * SCALE
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jctx, noise_override=override)
        for k, planner in enumerate(planners):
            states[k], info = planner.update(states[k], x0, time, ctx, noise_override=override)
            np.testing.assert_array_equal(states[k].costs[:, 0].numpy(), np.asarray(jax_state.costs)[:, 0])
            close(states[k].costs, jax_state.costs, "costs")
            close(noise_to_logical(states[k].noise), jax_state.noise, "noise")
            close(states[k].optimal_control, jax_state.optimal_control, "optimal_control")
            close(info.optimal_rollout_states, jax_info.optimal_rollout_states, "rollout-0 states")
            close(states[k].optimal_cost, jax_state.optimal_cost, "optimal_cost")
        for name in states[0]._fields:
            assert torch.equal(getattr(states[0], name), getattr(states[1], name)), name
    assert all(count == 0 for count in build.LAUNCHES.values())


@pytest.mark.parametrize("options", [{}, {"scenarios": 3}, {"safety": True}, {"sampler_shards": 2},
                                     {"optimal_rollout_mode": "resimulate"}],
                         ids=["serving", "scenarios", "safety", "twin", "resimulate"])
def test_lanes_flagship_publishes_what_the_kernel_path_does(options):
    """The same fresh draws through the lanes backend and through the cuda
    backend's plain kernel versions: the same lanes step, so bitwise."""
    rollouts, steps = 14, 4
    R_ = rollouts + 2
    rng = np.random.default_rng(6)
    lanes_flagship = build_flagship(rollouts, steps, device="cpu", dtype="float64", backend="lanes", **options)
    kernel_flagship = build_flagship(rollouts, steps, device="cpu", dtype="float64", **options)
    states = [lanes_flagship.init(seed=0), kernel_flagship.init(seed=0)]
    for time in (0.0, 0.01):
        fresh = rng.standard_normal((R_, steps, 12)) * SCALE
        (l_state, l_info), (k_state, k_info) = (
            f.update(s, f.x0, time, f.make_ctx(), fresh=fresh)
            for f, s in zip((lanes_flagship, kernel_flagship), states)
        )
        states = [l_state, k_state]
        for name in ("costs", "noise"):
            assert torch.equal(getattr(l_state, name), getattr(k_state, name)), name
        if options.get("optimal_rollout_mode") == "resimulate":
            close(l_state.optimal_cost, k_state.optimal_cost, "optimal_cost")
            close(l_info.optimal_rollout_states, k_info.optimal_rollout_states, "states")
        else:
            assert torch.equal(l_state.optimal_cost, k_state.optimal_cost)
            assert torch.equal(l_info.optimal_rollout_states, k_info.optimal_rollout_states)
        assert torch.equal(l_state.optimal_control, k_state.optimal_control)


def test_lanes_backend_is_picked_by_name_only(monkeypatch):
    with pytest.raises(ValueError, match="lanes backend has none"):
        build_flagship(rollouts=6, steps=3, device="cpu", backend="lanes", inkernel_rng=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(rollouts=6, steps=3, backend="lanes")


def test_lane_filter_rollout_matches_jax_and_kernel_2():
    """One optimal sequence re-rolled: against JAX's make_lane_filter_rollout
    and against kernel 2's plain version at R = 1
    (make_cuda_filter_rollout_fn)."""
    steps = 8
    rng = np.random.default_rng(9)
    optimal = 0.5 * rng.standard_normal((steps, 12)) * SCALE
    x0 = fr.make_state("huddled")
    x0[24:30] = rng.normal(size=6)  # a wrench in x0: carried, not applied
    ctx, jctx = contexts()
    args = (frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), steps, DT, 0.95)
    time = torch.tensor(0.01, dtype=torch.float64)
    cost, states = lane_rollout.make_lane_filter_rollout(*args)(torch.tensor(optimal), torch.tensor(x0), time, ctx)
    jcost, jstates = jax_lane_rollout.make_lane_filter_rollout(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), steps, DT, 0.95
    )(jnp.asarray(optimal), jnp.asarray(x0), jnp.asarray(0.01, jnp.float64), jctx)
    assert cost.shape == (2,) and states.shape == (steps, 31)
    assert float(cost[0]) == float(jcost[0])
    close(cost, jcost, "cost")
    close(states, jstates, "states")
    build.reset_launch_counts()
    kcost, kstates = make_cuda_filter_rollout_fn(*args, device="cpu")(
        torch.tensor(optimal), torch.tensor(x0), time, ctx)
    assert torch.equal(cost, kcost) and torch.equal(states, kstates)
    idle, _ = make_cuda_filter_rollout_fn(*args, device="cpu")(torch.tensor(optimal), torch.tensor(x0), time, None)
    lane_idle, _ = lane_rollout.make_lane_filter_rollout(*args)(torch.tensor(optimal), torch.tensor(x0), time, None)
    assert torch.equal(idle, lane_idle)
    assert all(count == 0 for count in build.LAUNCHES.values())
