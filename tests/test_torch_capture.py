"""The captured update's bookkeeping, on the CPU: static buffers, the state
the graph owns, the seeds a replay takes, launch counts. A CUDA graph cannot
be captured here, so a stand-in takes its place: "capture" runs the function
once and each "replay" runs it again on the same static buffers. Whatever
the stand-in shows (captured == eager, bitwise, for the same key) holds for
the real graph only if the capture records what the eager run does; that
is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch

from assistedmanipulation_tpu_torch import graphs
from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
from assistedmanipulation_tpu_torch.kernels import build
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, make_serving_tick
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS, ROLLOUTS = 5, 30


class _StandInGraph:
    """graphs.CapturedGraph's interface: the function run at capture and
    again at each replay."""

    def __init__(self, fn, generators=(), host_inputs=(), entry="graph"):
        self._fn = fn
        with build.capture_tally() as tally:
            self.outputs = fn()
        self.launches = {name: count for name, count in tally.items() if count}
        self.replays = 0

    def replay(self):
        self.outputs = self._fn()
        self.replays += 1
        return self.outputs


class _StandInHostInput:
    def __init__(self, shape, dtype, device):
        self.host = torch.zeros(shape, dtype=dtype)
        self.device = torch.zeros(shape, dtype=dtype, device=device)

    def write(self, value):
        self.host.copy_(value)

    def load(self):
        return self.device.copy_(self.host)

    def mark_read(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "CapturedGraph", _StandInGraph)
    monkeypatch.setattr(graphs, "require_cuda", lambda device, what: None)
    monkeypatch.setattr(graphs, "_on_card", lambda value: isinstance(value, torch.Tensor))
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    monkeypatch.setattr(cuda_rollout, "HostInput", _StandInHostInput)


def _equal(got, want) -> bool:
    """Equal to the last bit, NaN included."""
    if got.dtype in (torch.float32, torch.float64):
        bits = torch.int32 if got.dtype == torch.float32 else torch.int64
        return got.dtype == want.dtype and torch.equal(got.view(bits), want.view(bits))
    return torch.equal(got, want)


def _assert_equal(got, want, label):
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, tuple):
            _assert_equal(g, w, f"{label}.{name}")
        else:
            assert _equal(g, w), f"{label}.{name}"


@pytest.mark.parametrize("options", [
    {}, {"inkernel_rng": True}, {"scenarios": 3}, {"optimal_rollout_mode": "resimulate"},
], ids=["fused", "inkernel", "scenarios", "resimulate"])
def test_captured_flagship_bookkeeping_matches_eager(stand_in, options):
    """Five updates of build_flagship(capture=True) against the eager
    flagship from the same key: equal state and info every update; the
    returned state is the graph's own (a second call on it copies nothing
    in), a foreign state is copied in and left as it was."""
    eager = build_flagship(ROLLOUTS, STEPS, device="cpu", **options)
    captured = build_flagship(ROLLOUTS, STEPS, device="cpu", capture=True, **options)
    ctx = eager.make_ctx()
    initial = state = want = eager.init(seed=6)
    first = {name: value.clone() for name, value in initial._asdict().items()}
    for k in range(5):
        want, want_info = eager.update(want, eager.x0, 0.01 * k, ctx)
        state, info = captured.update(state, captured.x0, 0.01 * k, ctx)
        _assert_equal(state, want, f"update {k}: state")
        _assert_equal(info, want_info, f"update {k}: info")
        if k == 0:
            owned = captured.update.captured._state
            assert all(a is b for a, b in zip(state[:-4], owned[:-4]))
    graph = captured.update.captured.graph
    assert graph.replays == 5
    for name, value in initial._asdict().items():  # copied in, never written
        assert _equal(value, first[name]), name
    # Nor is a state passed in after the graph's own.
    keep = eager.init(seed=6)
    kept = {name: value.clone() for name, value in keep._asdict().items()}
    state, _ = captured.update(keep, captured.x0, 0.0, ctx)
    for name, value in keep._asdict().items():
        assert _equal(value, kept[name]), name


def test_captured_update_refuses_another_context(stand_in):
    flagship = build_flagship(ROLLOUTS, STEPS, device="cpu", capture=True)
    ctx = flagship.make_ctx()
    state, _ = flagship.update(flagship.init(seed=0), flagship.x0, 0.0, ctx)
    with pytest.raises(ValueError, match="ctx.time_step"):
        flagship.update(state, flagship.x0, 0.01, ctx._replace(time_step=0.02))
    with pytest.raises(TypeError, match="ctx: expected a ForecastContext"):
        flagship.update(state, flagship.x0, 0.01, None)


def test_captured_serving_tick_bookkeeping_matches_eager(stand_in):
    """Five ticks of make_serving_tick(capture=True) against the eager tick:
    equal forecast state, planner state, info and horizons; the scenario
    generator is left where the eager tick leaves it."""
    flagship = build_flagship(ROLLOUTS, STEPS, device="cpu", scenarios=3)
    forecast = KalmanForecast(KalmanForecastConfiguration(
        horizon=STEPS * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    generators = [torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)]
    eager = make_serving_tick(flagship, forecast, 3, generators[0])
    captured = make_serving_tick(flagship, forecast, 3, generators[1], capture=True)
    f_state = f_want = forecast.init(device="cpu")
    p_state = p_want = flagship.init(seed=2)
    for k in range(5):
        wrench = torch.tensor([20.0, 1.0 * k, 0.0, 0.0, 0.0, 0.0])
        f_want, p_want, want_info, want_horizons = eager(f_want, p_want, flagship.x0, wrench, 0.01 * k)
        f_state, p_state, info, horizons = captured(f_state, p_state, flagship.x0, wrench, 0.01 * k)
        assert _equal(horizons, want_horizons), k
        _assert_equal(f_state, f_want, f"tick {k}: forecast")
        _assert_equal(p_state, p_want, f"tick {k}: planner")
        _assert_equal(info, want_info, f"tick {k}: info")
