"""The port's eager serving tick (``parallel/flagship.make_serving_tick``:
the Kalman forecast update, 4 posterior scenarios, the planner update
scored under all 4) against the benchmark's plain reference
(``portbench/reference/tick.py`` and ``forecast.py``, plain float64 PyTorch)
at 30 rollouts x 8 steps x 4 scenarios on the CPU: the forecast state, the
4 horizons and the planner's output, tick by tick from the program's state
before each, with the port in float64 and in float32. A planted fault in
the scenario reduction (a scenario dropped, or the maximum in place of the
mean) fails the same comparison."""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, make_serving_tick
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.reference import tick as reference  # noqa: E402
from portbench.reference.keys import update_words  # noqa: E402

ROLLOUTS, STEPS, SCENARIOS, TICKS, SEED = 30, 8, 4, 4, 2147483659
CONFIG = json.loads((ROOT / "portbench" / "configs" / "franka-mppi-10k-50-kalman4.json").read_text())

# Tolerances, each with its reason. float64: the port and the reference run
# the same arithmetic by different code (the port's plain rollout kernel
# and solves, the reference's frozen lanes step), so they part by rounding
# alone, ~1e-13 relative; the limits leave four decades above it.
FLOAT64 = {
    "forecast": 1e-9,  # N, N/s, N^2: the filter's state, stack and covariance (values up to ~1e3)
    "horizons": 1e-9,  # N: the 4 horizons (|wrench| ~25 N, derivatives x 0.08 s)
    "control": 1e-9,  # share of each dof's control range: the published sequence and SG history
    "costs": 1e-9,  # relative: both cost channels of every rollout
}
# float32 against the float64 reference: float32 keeps ~7 digits. The
# first tick's derivative is ~1e3 N/s, and the filter's products round at
# ~6e-5 of it; the published controls move by the weights' float32 rounding
# (~1e-5 of the range at this size), the costs by ~1e-6 relative.
FLOAT32 = {"forecast": 1e-3, "horizons": 1e-4, "control": 1e-4, "costs": 1e-5}


def _config():
    config = copy.deepcopy(CONFIG)
    config["mppi"].update(rollouts=ROLLOUTS, keep_best_rollouts=ROLLOUTS // 5, horizon=STEPS * 0.01)
    return config


def _forecast_fields(state) -> dict:
    return {"state": state.filter.state, "next_state": state.filter.next_state,
            "covariance": state.filter.covariance, "measurement": state.measurement,
            "prediction": state.prediction, "last_update": state.last_update}


def _worst(got: torch.Tensor, want: torch.Tensor, scale=1.0) -> float:
    return float(((got.double() - want.double()).abs() / scale).max())


def _drive(precision: str, ticks: int = TICKS):
    """``ticks`` eager ticks of the port on a seeded random push; for each,
    the program's state before and after it and the reference's tick from
    the state before."""
    dtype = getattr(torch, precision)
    config = _config()
    setup = reference.TickSetup.from_config(config)
    f = config["forecast"]
    flagship = build_flagship(ROLLOUTS, STEPS, device="cpu", dtype=precision, scenarios=SCENARIOS)
    forecast = KalmanForecast(KalmanForecastConfiguration(
        order=f["order"], time_step=f["time_step"], horizon=f["horizon"],
        observation_variance=f["observation_variance"], transition_variance=f["transition_variance"],
    ))
    generator = torch.Generator().manual_seed(11)
    tick = make_serving_tick(flagship, forecast, SCENARIOS, generator)
    pushes = np.random.default_rng(5).normal([20.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.5] * 3 + [0.0] * 3, (ticks, 6))
    words = update_words(SEED, ticks)
    f_state, p_state = forecast.init(dtype=dtype, device="cpu"), flagship.init(SEED)
    out = []
    for k in range(ticks):
        before = {name: getattr(p_state, name).clone() for name in reference.PLANNER_FIELDS}
        before.update(forecast={n: v.clone() for n, v in _forecast_fields(f_state).items()},
                      scenario_rng=generator.get_state())
        push = torch.as_tensor(pushes[k], dtype=dtype)
        time = 0.01 * (k + 1)
        f_state, p_state, _, horizons = tick(f_state, p_state, flagship.x0, push, time)
        expected = reference.tick(setup, before, push, time, words[k][1], torch.float64)
        out.append((setup, f_state, p_state, horizons, generator.get_state(), expected))
    return out


def _gaps(setup, f_state, p_state, horizons, expected) -> dict:
    span = torch.as_tensor(setup.planner.control_max - setup.planner.control_min)
    forecast = max(_worst(value, expected["forecast"][name]) for name, value in _forecast_fields(f_state).items())
    costs = p_state.costs.double()
    want = expected["costs"]
    return {
        "forecast": forecast,
        "horizons": _worst(horizons, expected["horizons"]),
        "control": max(_worst(p_state.optimal_control, expected["optimal_control"], span),
                       _worst(p_state.sg_buffer, expected["sg_buffer"], span[:, None])),
        "costs": float(((costs - want).abs() / want.abs().clamp(min=1e-12)).max()),
    }


@pytest.mark.parametrize("precision, tolerances", [("float64", FLOAT64), ("float32", FLOAT32)],
                         ids=["float64", "float32"])
def test_the_eager_tick_matches_the_reference(precision, tolerances):
    for k, (setup, f_state, p_state, horizons, rng_after, expected) in enumerate(_drive(precision)):
        assert horizons.shape == (SCENARIOS, setup.forecast.steps + 1, 6)
        # Scenario 0 is the posterior mean prediction, bit for bit.
        assert torch.equal(horizons[0], f_state.prediction)
        gaps = _gaps(setup, f_state, p_state, horizons, expected)
        for name, limit in tolerances.items():
            assert gaps[name] <= limit, (k, name, gaps)
        # The draws, their generator and the tick's times: exact.
        assert torch.equal(rng_after, expected["scenario_rng"])
        assert torch.equal(p_state.noise, expected["noise"].to(p_state.noise.dtype))
        assert float(f_state.last_update) == float(expected["forecast"]["last_update"])
        assert int(p_state.update_count) == int(expected["update_count"]) == k + 1


@pytest.mark.parametrize("reduction", [
    lambda costs, weights=None: torch.mean(costs[:-1], dim=0),
    lambda costs, weights=None: torch.amax(costs, dim=0),
], ids=["scenario-dropped", "max-not-mean"])
def test_a_wrong_scenario_reduction_fails(reduction, monkeypatch):
    monkeypatch.setattr(cuda_rollout, "reduce_scenarios", reduction)
    worst = max(_gaps(s, f, p, h, e)["costs"] for s, f, p, h, _, e in _drive("float64", ticks=2))
    assert worst > 1e3 * FLOAT64["costs"]
