"""The CUDA kernels (fused sample+rollout, two-pass rollout at one and at
several scenarios, in-kernel-RNG sample+rollout, FP32 chain) against their
plain PyTorch versions, on the card, and the fused kernels' longest
horizons. These tests need a CUDA device and skip without one; they import
nothing of JAX, so on a machine with a card and no JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

Tolerances as chip_smoke.py states them: noise bitwise (for the in-kernel
draws: noise that is not a fresh draw bitwise, fresh draws within 4e-6 x
the dof's scale), violation counts exact, smooth costs and states within
1e-4 * max(|plain|, 1); the FP32 chain's add leg bitwise, its FMA leg within
rtol 1e-5.
"""

import pytest
import torch

from assistedmanipulation_tpu_torch.kernels import cuda_rollout, fp32_chain
from assistedmanipulation_tpu_torch.kernels.philox import normal_draws, seed_words
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, synthetic_wrench_horizons

pytestmark = pytest.mark.gpu

STEPS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rollouts, shift, do_shift, device, dtype=torch.float32, steps=STEPS):
    g = torch.Generator(device=device).manual_seed(rollouts + shift)
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=dtype, device=device).sqrt()
    old = torch.randn((steps, 12, rollouts), generator=g, device=device, dtype=dtype) * scale[None, :, None]
    fresh = torch.randn((steps, 12, rollouts), generator=g, device=device, dtype=dtype) * scale[None, :, None]
    keep = torch.rand(rollouts, generator=g, device=device) < 0.25
    keep[:2] = False
    x0 = torch.tensor(fr.make_state("huddled"), dtype=dtype, device=device)
    optimal = 0.3 * torch.randn((steps, 12), generator=g, device=device, dtype=dtype)
    init, table = cuda_rollout.rollout_inputs(
        ObjectiveConfiguration(), steps, 0.01, 1.0, x0, torch.zeros((), dtype=dtype, device=device),
        None, optimal, optimal.flip(0),
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32, device=device)
    return init, table, meta, old, fresh, keep


def _spec():
    return cuda_rollout.RolloutSpec(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01
    )


@pytest.mark.parametrize("rollouts", [33, 257, 1000])
@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False), (STEPS, True)])
def test_kernel_matches_plain_version(cuda, rollouts, shift, do_shift):
    inputs = _inputs(rollouts, shift, do_shift, cuda)
    noise, costs, states = cuda_rollout.fused_sample_rollout(_spec(), *inputs)
    want_noise, want_costs, want_states = cuda_rollout.fused_sample_rollout_reference(_spec(), *inputs)
    assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    assert torch.equal(costs[:, 0], want_costs[:, 0])
    for got, want in ((costs[:, 1], want_costs[:, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()


def test_kernel_counts_its_launches_and_refuses_float64(cuda):
    cuda_rollout.reset_launch_counts()
    cuda_rollout.fused_sample_rollout(_spec(), *_inputs(64, 0, False, cuda))
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout.fused_sample_rollout(_spec(), *_inputs(64, 0, False, cuda, torch.float64))
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 1


def test_flagship_updates_go_through_the_kernel(cuda):
    flagship = build_flagship(rollouts=510, steps=STEPS)
    state, ctx = flagship.init(seed=0), flagship.make_ctx()
    cuda_rollout.reset_launch_counts()
    for k in range(4):
        state, info = flagship.update(state, flagship.x0, 0.01 * k, ctx)
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 4
    assert torch.isfinite(state.optimal_control).all()
    assert not bool(info.degenerate)


@pytest.mark.parametrize("name", ["fused_sample_rollout", "inkernel_rng_sample_rollout"])
def test_fused_kernels_launch_at_their_longest_horizon(cuda, name):
    """Each fused library exports its longest horizon, the wrapper's
    constant. A launch at that S (the table, and the fused kernel's state
    ring, filling a block's shared memory) gives noise bitwise the plain
    assembly's and, with no shift, rollout 0's first 16 states bitwise those
    of a 16-step launch on the same inputs; one step more is refused before
    any launch."""
    from assistedmanipulation_tpu_torch.kernels import build

    limit = cuda_rollout.SHARED_MEMORY_LIMITS[name][1]
    assert cuda_rollout.exported_limit(build.load(name), name) == limit
    init, table, meta, old, fresh, keep = _inputs(33, 0, False, cuda, steps=limit)
    optimal = table[:, cuda_rollout.COL_OPTIMAL:cuda_rollout.COL_OPTIMAL + 12]
    if name == "fused_sample_rollout":
        def launch(steps):
            return cuda_rollout.fused_sample_rollout(
                _spec(), init, table[:steps].contiguous(), meta, old[:steps].contiguous(),
                fresh[:steps].contiguous(), keep)
    else:
        seed = seed_words(torch.Generator(device=cuda).manual_seed(5))
        scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=torch.float32, device=cuda).sqrt()
        fresh = normal_draws(seed, limit, 33, scale)

        def launch(steps):
            return cuda_rollout.inkernel_rng_sample_rollout(
                _spec(), init, table[:steps].contiguous(), meta, old[:steps].contiguous(), keep, seed, scale)
    cuda_rollout.reset_launch_counts()
    noise, costs, states = launch(limit)
    _, _, prefix = launch(STEPS)
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES[name] == 2
    want = cuda_rollout.assemble_noise(optimal, meta, old, fresh, keep)
    drawn = cuda_rollout.fresh_mask(meta, keep, limit).expand_as(noise)
    if name == "fused_sample_rollout":
        assert torch.equal(noise.view(torch.int32), want.view(torch.int32))
    else:
        assert torch.equal(noise.view(torch.int32)[~drawn], want.view(torch.int32)[~drawn])
        assert ((noise - want).abs() <= 4e-6 * scale[None, :, None])[drawn].all()
    assert states.shape == (limit, 24) and torch.equal(states[:STEPS], prefix)
    assert costs.shape == (33, 2)
    init, table, meta, old, fresh, keep = _inputs(2, 0, False, cuda, steps=limit + 1)
    with pytest.raises(ValueError, match=f"at most {limit} steps"):
        if name == "fused_sample_rollout":
            cuda_rollout.fused_sample_rollout(_spec(), init, table, meta, old, fresh, keep)
        else:
            cuda_rollout.inkernel_rng_sample_rollout(_spec(), init, table, meta, old, keep, seed, scale)
    assert cuda_rollout.LAUNCHES[name] == 2


def _controls(rollouts, device, dtype=torch.float32):
    """Absolute controls (noise + optimal) and the two-pass kernel's inputs,
    with a forecast context."""
    init, _, meta, old, fresh, keep = _inputs(rollouts, 2, True, device, dtype)
    optimal = 0.3 * old[:, :, 0]  # any (S, 12) sequence
    noise = cuda_rollout.assemble_noise(optimal, meta, old, fresh, keep)
    x0 = torch.tensor(fr.make_state("huddled"), dtype=dtype, device=device)
    ctx = ForecastContext(
        synthetic_wrench_horizons(STEPS, device=device, dtype=dtype),
        torch.zeros((), dtype=dtype, device=device), 0.01, STEPS * 0.01,
    )
    table = cuda_rollout.step_table(
        ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0, torch.tensor(0.013, dtype=dtype, device=device), ctx
    )
    return init, table, (noise + 0.5 * optimal[:, :, None]).contiguous()


@pytest.mark.parametrize("name", sorted(cuda_rollout.SHARED_MEMORY_LIMITS))
def test_each_library_exports_its_shared_memory_limit(cuda, name):
    """The fused kernels' longest horizon and the two-pass kernel's most
    table rows, as each library exports them, are the wrapper's constants
    (the wrapper also checks them when it loads a library)."""
    from assistedmanipulation_tpu_torch.kernels import build

    assert cuda_rollout.exported_limit(build.load(name), name) == cuda_rollout.SHARED_MEMORY_LIMITS[name][1]


# R = 1: the resimulate re-rollout, one live lane per warp of the pair;
# 33: a second pair with one live lane.
@pytest.mark.parametrize("rollouts", [1, 33, 257, 1000])
def test_rollout_kernel_matches_plain_version(cuda, rollouts):
    init, table, controls = _controls(rollouts, cuda)
    costs, states = cuda_rollout.rollout(_spec(), init, table, controls)
    want_costs, want_states = cuda_rollout.rollout_reference(_spec(), init, table, controls)
    assert costs.shape == (rollouts, 2) and states.shape == (STEPS, 24)
    assert torch.equal(costs[:, 0], want_costs[:, 0])
    for got, want in ((costs[:, 1], want_costs[:, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()


def test_rollout_kernel_counts_its_launches_and_refuses_float64(cuda):
    cuda_rollout.reset_launch_counts()
    cuda_rollout.rollout(_spec(), *_controls(64, cuda))
    assert cuda_rollout.LAUNCHES["rollout"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout.rollout(_spec(), *_controls(64, cuda, torch.float64))
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 1, "inkernel_rng_sample_rollout": 0, "fp32_chain": 0,
    }


def test_scenario_flagship_goes_through_the_rollout_kernel(cuda):
    scenarios = 3
    flagship = build_flagship(rollouts=510, steps=STEPS, scenarios=scenarios)
    state, ctx = flagship.init(seed=0), flagship.make_ctx()
    cuda_rollout.reset_launch_counts()
    for k in range(4):
        state, info = flagship.update(state, flagship.x0, 0.01 * k, ctx)
    assert cuda_rollout.LAUNCHES == {  # one launch per update for all scenarios
        "fused_sample_rollout": 0, "rollout": 4, "inkernel_rng_sample_rollout": 0, "fp32_chain": 0,
    }
    assert torch.isfinite(state.optimal_control).all()
    assert torch.isfinite(info.optimal_rollout_states).all()
    assert not bool(info.degenerate)


@pytest.mark.parametrize("rollouts", [1, 33, 300])
@pytest.mark.parametrize("scenarios", [2, 4, cuda_rollout.MAX_SCENARIOS])
def test_multi_scenario_rollout_kernel_matches_plain_version_and_single_launches(cuda, scenarios, rollouts):
    """C scenarios in one launch: each scenario's costs against the plain
    version, and bitwise equal to a one-scenario launch on its table; the
    states are the one-scenario launch's."""
    init, _, controls = _controls(rollouts, cuda)
    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float32, device=cuda)
    ctx = ForecastContext(
        synthetic_wrench_horizons(STEPS, scenarios, device=cuda), torch.zeros((), device=cuda), 0.01, STEPS * 0.01,
    )
    tables = cuda_rollout.step_table(ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0, torch.tensor(0.013, device=cuda), ctx)
    costs, states = cuda_rollout.rollout(_spec(), init, tables, controls)
    want_costs, want_states = cuda_rollout.rollout_reference(_spec(), init, tables, controls)
    assert costs.shape == (scenarios, rollouts, 2)
    assert torch.equal(costs[:, :, 0], want_costs[:, :, 0])
    for got, want in ((costs[:, :, 1], want_costs[:, :, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()
    for c in range(scenarios):
        single, single_states = cuda_rollout.rollout(_spec(), init, tables[c].contiguous(), controls)
        assert torch.equal(single.view(torch.int32), costs[c].view(torch.int32))
        assert torch.equal(single_states, states)


def test_multi_scenario_rollout_kernel_counts_one_launch_and_refuses_too_many(cuda):
    init, table, controls = _controls(64, cuda)
    cuda_rollout.reset_launch_counts()
    cuda_rollout.rollout(_spec(), init, table.expand(3, -1, -1).contiguous(), controls)
    assert cuda_rollout.LAUNCHES["rollout"] == 1
    with pytest.raises(ValueError, match="compiled for"):
        cuda_rollout.rollout(
            _spec(), init, table.expand(cuda_rollout.MAX_SCENARIOS + 1, -1, -1).contiguous(), controls
        )
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rollout.rollout(_spec(), init, table.repeat(4, 114, 1), controls.repeat(114, 1, 1))
    assert cuda_rollout.LAUNCHES["rollout"] == 1


def test_rollout_kernel_takes_tables_past_48_kb(cuda):
    """2,000 steps put a 64 KB table in shared memory (the opt-in path):
    rollout 0's states over the first 500 steps are bitwise those of a
    500-step launch on the same controls; past ROLLOUT_MAX_TABLE_ROWS =
    6,878 steps the wrapper refuses before launching."""
    init, table, controls = _controls(256, cuda)
    long_table = table.repeat(125, 1)
    long_controls = controls.repeat(125, 1, 1)
    _, states = cuda_rollout.rollout(_spec(), init, long_table, long_controls)
    _, prefix = cuda_rollout.rollout(_spec(), init, long_table[:500].contiguous(), long_controls[:500].contiguous())
    torch.cuda.synchronize()
    assert states.shape == (2000, 24)
    assert torch.equal(states[:500], prefix)
    past = cuda_rollout.ROLLOUT_MAX_TABLE_ROWS // STEPS + 1
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rollout.rollout(_spec(), init, table.repeat(past, 1), controls.repeat(past, 1, 1))


def _inkernel_inputs(rollouts, shift, do_shift, device, dtype=torch.float32):
    init, table, meta, old, _, keep = _inputs(rollouts, shift, do_shift, device, dtype)
    seed = seed_words(torch.Generator(device=device).manual_seed(rollouts))
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=dtype, device=device).sqrt()
    return init, table, meta, old, keep, seed, scale


@pytest.mark.parametrize("rollouts", [33, 257, 1000])
@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False), (STEPS, True)])
def test_inkernel_kernel_matches_plain_version(cuda, rollouts, shift, do_shift):
    inputs = _inkernel_inputs(rollouts, shift, do_shift, cuda)
    init, table, meta, old, keep, seed, scale = inputs
    noise, costs, states = cuda_rollout.inkernel_rng_sample_rollout(_spec(), *inputs)
    fresh = normal_draws(seed, STEPS, rollouts, scale)
    want_noise = cuda_rollout.assemble_noise(
        table[:, cuda_rollout.COL_OPTIMAL:cuda_rollout.COL_OPTIMAL + 12], meta, old, fresh, keep
    )
    drawn = cuda_rollout.fresh_mask(meta, keep, STEPS).expand_as(noise)
    assert torch.equal(noise.view(torch.int32)[~drawn], want_noise.view(torch.int32)[~drawn])
    assert ((noise - want_noise).abs() <= 4e-6 * scale[None, :, None])[drawn].all()
    controls = noise + table[:, cuda_rollout.COL_OPTSHIFT:cuda_rollout.COL_OPTSHIFT + 12, None]
    want_costs, want_states = cuda_rollout.rollout_reference(_spec(), init, table, controls)
    assert torch.equal(costs[:, 0], want_costs[:, 0])
    for got, want in ((costs[:, 1], want_costs[:, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()


def test_inkernel_kernel_counts_its_launches_and_refuses_float64(cuda):
    cuda_rollout.reset_launch_counts()
    cuda_rollout.inkernel_rng_sample_rollout(_spec(), *_inkernel_inputs(64, 0, False, cuda))
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 0, "inkernel_rng_sample_rollout": 1, "fp32_chain": 0,
    }
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout.inkernel_rng_sample_rollout(_spec(), *_inkernel_inputs(64, 0, False, cuda, torch.float64))
    assert cuda_rollout.LAUNCHES["inkernel_rng_sample_rollout"] == 1


def test_inkernel_flagship_goes_through_its_kernel(cuda):
    flagship = build_flagship(rollouts=510, steps=STEPS, inkernel_rng=True)
    state, ctx = flagship.init(seed=0), flagship.make_ctx()
    cuda_rollout.reset_launch_counts()
    for k in range(4):
        state, info = flagship.update(state, flagship.x0, 0.01 * k, ctx)
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 0, "inkernel_rng_sample_rollout": 4, "fp32_chain": 0,
    }
    assert torch.isfinite(state.optimal_control).all()
    assert not bool(info.degenerate)


@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("accumulators", [1, 16])
def test_chain_kernel_matches_plain_version(cuda, fma, accumulators):
    x = 1.0 + 1e-3 * torch.rand(3000, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    got = fp32_chain.chain(x, 4, accumulators, fma)
    want = fp32_chain.chain_reference(x, 4, accumulators, fma)
    fp32_chain.compare_to_reference(got, want, fma)


def test_chain_kernel_counts_its_launches_and_refuses_float64(cuda):
    cuda_rollout.reset_launch_counts()
    fp32_chain.chain(torch.ones(100, device=cuda), 2, 4, True, unroll=2)
    assert cuda_rollout.LAUNCHES["fp32_chain"] == 1
    with pytest.raises(TypeError, match="float32"):
        fp32_chain.chain(torch.ones(100, device=cuda, dtype=torch.float64), 2, 4, True)
    with pytest.raises(ValueError, match="among"):
        fp32_chain.chain(torch.ones(100, device=cuda), 2, 3, True)
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 0, "inkernel_rng_sample_rollout": 0, "fp32_chain": 1,
    }


def _bitwise(got, want) -> bool:
    """Equal to the last bit (NaN included) for float32, equal otherwise."""
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def _assert_bitwise(got, want, label):
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, tuple):
            _assert_bitwise(g, w, f"{label}.{name}")
        else:
            assert _bitwise(g, w), f"{label}.{name}"


CAPTURE_CELLS = {
    "fused": ({}, "fused_sample_rollout"),
    "inkernel": ({"inkernel_rng": True}, "inkernel_rng_sample_rollout"),
    "scenarios": ({"scenarios": 4}, "rollout"),
    "resimulate": ({"optimal_rollout_mode": "resimulate"}, "fused_sample_rollout"),
}


@pytest.mark.parametrize("cell", sorted(CAPTURE_CELLS))
def test_captured_update_is_bitwise_the_eager_one(cuda, cell):
    """build_flagship(capture=True) over 5 updates: every state field and
    every info output bitwise the eager flagship's from the same key, and
    each replay counted as one launch of the cell's kernel (two kernel
    launches per update in resimulate mode: the batch and the re-rollout)."""
    options, kernel = CAPTURE_CELLS[cell]
    eager = build_flagship(rollouts=998, steps=STEPS, **options)
    captured = build_flagship(rollouts=998, steps=STEPS, capture=True, **options)
    ctx = eager.make_ctx()
    times = torch.arange(5, dtype=torch.float32, device=cuda) * 0.01
    state, want_state = captured.init(seed=4), eager.init(seed=4)
    for k in range(5):
        if k == 1:
            cuda_rollout.reset_launch_counts()
        want_state, want_info = eager.update(want_state, eager.x0, times[k], ctx)
        state, info = captured.update(state, captured.x0, times[k], ctx)
        _assert_bitwise(state, want_state, f"update {k}: state")
        _assert_bitwise(info, want_info, f"update {k}: info")
    expected = {kernel: 8}
    if cell == "resimulate":
        expected["rollout"] = 8
    assert {name: n for name, n in cuda_rollout.LAUNCHES.items() if n} == expected
    assert captured.update.captured.graph.launches == {name: n // 8 for name, n in expected.items()}


def test_captured_serving_tick_is_bitwise_the_eager_one(cuda):
    """The Kalman-driven tick (forecast update, 4 scenarios, planner update)
    as one graph against the eager tick, 5 ticks from the same states and
    generator seed."""
    from assistedmanipulation_tpu_torch.forecast.forecast import (
        KalmanForecast, KalmanForecastConfiguration,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import make_serving_tick

    flagship = build_flagship(rollouts=998, steps=STEPS, scenarios=4)
    forecast = KalmanForecast(KalmanForecastConfiguration(
        time_step=0.01, horizon=STEPS * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    eager = make_serving_tick(flagship, forecast, 4, torch.Generator(device=cuda).manual_seed(3))
    captured = make_serving_tick(flagship, forecast, 4, torch.Generator(device=cuda).manual_seed(3), capture=True)
    f_state = f_want = forecast.init(device=cuda)
    p_state = p_want = flagship.init(seed=1)
    for k in range(5):
        wrench = torch.tensor([20.0, 2.0 * k, 0.0, 0.0, 0.0, 0.0], device=cuda)
        time = torch.tensor(0.01 * k, device=cuda)
        f_want, p_want, want_info, want_horizons = eager(f_want, p_want, flagship.x0, wrench, time)
        f_state, p_state, info, horizons = captured(f_state, p_state, flagship.x0, wrench, time)
        assert _bitwise(horizons, want_horizons), f"tick {k}: horizons"
        _assert_bitwise(f_state, f_want, f"tick {k}: forecast state")
        _assert_bitwise(p_state, p_want, f"tick {k}: planner state")
        _assert_bitwise(info, want_info, f"tick {k}: info")


PLANT_CELLS = {
    "safety": ({"safety": True}, {"fused_sample_rollout": 1}),
    "vmap": ({"backend": "vmap"}, {}),
}


@pytest.mark.parametrize("cell", sorted(PLANT_CELLS))
def test_captured_plant_path_is_bitwise_the_eager_one(cuda, cell):
    """The paths through the plant in plain PyTorch captured over 3
    updates: every state field and info output bitwise the eager
    flagship's, kernel 1 launched once per update on the safety path (its
    filtered re-rollout runs through the plant) and no kernel at all on the
    vmap path."""
    options, per_update = PLANT_CELLS[cell]
    eager = build_flagship(rollouts=510, steps=STEPS, **options)
    captured = build_flagship(rollouts=510, steps=STEPS, capture=True, **options)
    ctx = eager.make_ctx()
    times = torch.arange(3, dtype=torch.float32, device=cuda) * 0.01
    state, want_state = captured.init(seed=4), eager.init(seed=4)
    cuda_rollout.reset_launch_counts()
    for k in range(3):
        want_state, want_info = eager.update(want_state, eager.x0, times[k], ctx)
        state, info = captured.update(state, captured.x0, times[k], ctx)
        _assert_bitwise(state, want_state, f"update {k}: state")
        _assert_bitwise(info, want_info, f"update {k}: info")
    # Eager: 3 updates; captured: the eager first call and 3 replays.
    assert {name: n for name, n in cuda_rollout.LAUNCHES.items() if n} == {
        name: 7 * n for name, n in per_update.items()
    }
    assert captured.update.captured.graph.launches == per_update


def _circle_episode(device, capture, duration, dynamics_type="analytic"):
    import dataclasses

    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation
    from assistedmanipulation_tpu_torch.sim import actor, episode, trajectories

    configuration = dataclasses.replace(actor.Configuration().mppi, rollouts=30, keep_best_rollouts=10)
    return episode.Episode(
        configuration, AssistedManipulation(),
        trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
        episode.EpisodeConfiguration(duration=duration), collect_logs=True, device=device, capture=capture,
        # The harness's lagrangian case: the plant on the chosen backend,
        # the planner's rollouts on the analytic one.
        robot_configuration=fr.Configuration(dynamics_type=dynamics_type, rollout_dynamics_type="analytic"),
    )


def _assert_tree_bitwise(got, want, label):
    if isinstance(got, tuple):
        for index, (g, w) in enumerate(zip(got, want)):
            _assert_tree_bitwise(g, w, f"{label}.{getattr(got, '_fields', range(len(got)))[index]}")
    elif isinstance(got, torch.Tensor):
        assert _bitwise(got.to(want.device), want), label
    else:
        assert got == want, label


@pytest.mark.parametrize("dynamics_type,noise", [("analytic", False), ("analytic", True), ("lagrangian", False)])
def test_captured_episode_is_bitwise_the_eager_one(cuda, dynamics_type, noise):
    """The circle episode captured (the first period eager, then one CUDA
    graph replay per 10-tick controller period, the partial last period
    eager) against the same episode eager: 45 ticks = the first period, 3
    replays and 5 ticks; every output, log and the final carry bitwise
    equal, from the same key, with the sampler's own draws or injected
    noise. The lagrangian case puts torch.func's hessian and grad (the
    plant's backend; the rollouts stay analytic, as in the harness's case)
    inside the graph."""
    duration = 0.225
    eager = _circle_episode(cuda, False, duration, dynamics_type)
    captured = _circle_episode(cuda, True, duration, dynamics_type)
    override = None
    if noise:
        g = torch.Generator(device=cuda).manual_seed(6)
        override = torch.randn((5, 30, eager.planner.steps, 12), generator=g, device=cuda)
    want = eager.run(seed=3, noise_override=override)
    got = captured.run(seed=3, noise_override=override)
    assert captured.graph is not None and eager.graph is None
    _assert_tree_bitwise(got, want, "episode")
    _assert_tree_bitwise(captured.final_carry, eager.final_carry, "final carry")
    assert int(want[1].update_fired.sum()) == 5 and torch.isfinite(want[1].x).all()


def test_captured_actor_is_bitwise_the_eager_one(cuda):
    """The actor's host loop with the planner update captured
    (``Planner.capture``, the default on a card) against the eager one over
    25 ticks (3 updates): states and controls bitwise."""
    import dataclasses

    from assistedmanipulation_tpu_torch.sim import actor

    configuration = actor.Configuration()
    configuration.mppi = dataclasses.replace(configuration.mppi, rollouts=30, keep_best_rollouts=10)
    eager = actor.Actor(configuration, 0.005, device=cuda, capture=False)
    captured = actor.Actor(configuration, 0.005, device=cuda)
    assert captured.capture
    wrench = torch.tensor([20.0, -5.0, 0.0, 0.0, 0.0, 0.0], device=cuda)
    for i in range(25):
        for a in (eager, captured):
            a.add_end_effector_wrench(wrench * (1 + 0.1 * i), i * 0.005)
            a.act(i * 0.005)
        assert _bitwise(captured.x, eager.x), f"tick {i}: x"
        assert _bitwise(captured.control, eager.control), f"tick {i}: control"


@pytest.mark.parametrize("kernel", ["fused", "inkernel"])
def test_kernels_match_plain_versions_on_a_block_without_the_statics(cuda, kernel):
    """``meta[2] = 0``: a rollout shard that does not hold static rollouts 0
    and 1 (parallel/sharding.py) samples its rows 0 and 1 like any other."""
    if kernel == "fused":
        inputs = _inputs(1000, 2, True, cuda)
        inputs[2][2] = 0
        noise, costs, states = cuda_rollout.fused_sample_rollout(_spec(), *inputs)
        want_noise, want_costs, want_states = cuda_rollout.fused_sample_rollout_reference(_spec(), *inputs)
        assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    else:
        inputs = _inkernel_inputs(1000, 2, True, cuda)
        init, table, meta, old, keep, seed, scale = inputs
        meta[2] = 0
        noise, costs, states = cuda_rollout.inkernel_rng_sample_rollout(_spec(), *inputs)
        drawn = cuda_rollout.fresh_mask(meta, keep, STEPS).expand_as(noise)
        want_noise = cuda_rollout.assemble_noise(
            table[:, cuda_rollout.COL_OPTIMAL:cuda_rollout.COL_OPTIMAL + 12], meta, old,
            normal_draws(seed, STEPS, 1000, scale), keep,
        )
        assert torch.equal(noise.view(torch.int32)[~drawn], want_noise.view(torch.int32)[~drawn])
        assert ((noise - want_noise).abs() <= 4e-6 * scale[None, :, None])[drawn].all()
        controls = noise + table[:, cuda_rollout.COL_OPTSHIFT:cuda_rollout.COL_OPTSHIFT + 12, None]
        step_table = torch.cat([table[:, :cuda_rollout.COL_OPTIMAL], table[:, -1:]], dim=1).contiguous()
        want_costs, want_states = cuda_rollout.rollout_reference(_spec(), init, step_table, controls)
    assert bool(noise[:, :10, :2].ne(0).all())  # rows 0 and 1 sampled (dofs 10, 11 have zero variance)
    assert torch.equal(costs[:, 0], want_costs[:, 0])
    for got, want in ((costs[:, 1], want_costs[:, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()


def test_sharded_twin_matches_the_unsharded_flagship_and_captures(cuda):
    """``build_flagship(sampler_shards=2)`` fed the unsharded flagship's
    fresh draws: the noise, costs and states bitwise (the same kernel on
    blocks of the same rollouts), the controls within 1e-3; two kernel-1
    launches per update; captured, bitwise its eager self."""
    twin, single = build_flagship(rollouts=998, steps=STEPS, sampler_shards=2), build_flagship(rollouts=998, steps=STEPS)
    ctx = twin.make_ctx()
    state = want = twin.init(seed=2)
    generator = torch.Generator().manual_seed(0)
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=torch.float32).sqrt()
    cuda_rollout.reset_launch_counts()
    for k in range(3):
        fresh = torch.randn((1000, STEPS, 12), generator=generator) * scale
        state, info = twin.update(state, twin.x0, 0.01 * k, ctx, fresh=fresh)
        want, want_info = single.update(want, single.x0, 0.01 * k, ctx, fresh=fresh)
        for got, expected in ((state.noise, want.noise), (state.costs, want.costs),
                              (info.optimal_rollout_states, want_info.optimal_rollout_states)):
            assert _bitwise(got, expected)
        assert float((state.optimal_control - want.optimal_control).abs().max()) <= 1e-3
        want = state
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 3 * 3  # 2 per twin update, 1 per single one
    captured = build_flagship(rollouts=998, steps=STEPS, sampler_shards=2, capture=True)
    state, want_state = captured.init(seed=4), twin.init(seed=4)
    for k in range(4):
        want_state, want_info = twin.update(want_state, twin.x0, 0.01 * k, ctx)
        state, info = captured.update(state, captured.x0, 0.01 * k, ctx)
        _assert_bitwise(state, want_state, f"update {k}: state")
        _assert_bitwise(info, want_info, f"update {k}: info")
    assert captured.update.captured.graph.launches == {"fused_sample_rollout": 2}


def test_two_ranks_on_the_card_match_the_twin(cuda, tmp_path):
    """scripts/torch_multihost_check.py: 2 gloo ranks on this card, each
    case against its ``sampler_shards`` twin on the same card."""
    import json
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                          "torch_multihost_check.py")
    proc = subprocess.run(
        [sys.executable, script, "--device", "cuda", "--rollouts", "510", "--steps", str(STEPS), "--updates", "4",
         "--cases", "fused,inkernel,vmap,scenario", "--store", str(tmp_path), "--timeout", "240"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and all(result["cases"][case]["bitwise"] for case in ("fused", "inkernel", "vmap"))
