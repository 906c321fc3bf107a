"""The port's tracer (``assistedmanipulation_tpu_torch.tracing``): off by
default and free of records, on under ``collect()`` or a collecting
``torch.profiler``, its launch registry the one ``kernels/build`` counts in,
and its device timelines read into spans that tile each update.

The CPU tests drive an eager update at a tiny size, and the device-timeline
arithmetic on stand-in events. The card tests (marker ``gpu``; they skip
without a card and import nothing of JAX) time the captured 10,000 x 50
serving update, its safety-filtered twin and the Kalman-driven serving
tick over 4 scenarios:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m gpu
"""

import gc

import pytest
import torch

from assistedmanipulation_tpu_torch import graphs, tracing
from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, make_serving_tick

# Device spans inside one serving update, in timeline order.
SERVE_SPANS = ("planner.elite", "sampler.draws", "sampler.kernel", "planner.optimise", "planner.sg", "update.state")
SAFETY_SPANS = SERVE_SPANS + ("planner.rerollout", "filter.model", "filter.qp", "plant.step")
# Device spans inside one serving tick: the forecast's two, then the update's.
TICK_SPANS = ("forecast.kalman", "forecast.scenarios") + SERVE_SPANS


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def cpu_flagship():
    return build_flagship(rollouts=14, steps=3, device="cpu")


def _update(flagship, state, time):
    return flagship.update(state, flagship.x0, time, flagship.make_ctx())[0]


def test_off_an_eager_update_records_nothing_and_never_enters_record_function(cpu_flagship, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    state = _update(cpu_flagship, cpu_flagship.init(0), torch.tensor(0.01))
    _update(cpu_flagship, state, 0.02)
    assert not tracing.enabled()
    recorded = tracing.records()
    assert recorded.sums == {} and recorded.counters == {} and recorded.spans == []
    assert tracing.span("update") is tracing.span("graph.replay")  # one shared no-op


def test_collect_records_host_spans_with_parents_one_update_id_and_load_counters(cpu_flagship):
    state = cpu_flagship.init(0)
    with tracing.collect() as recorded:
        state = _update(cpu_flagship, state, torch.tensor(0.01))  # x and time given where they are read
        _update(cpu_flagship, state, 0.02)  # a number for the time: filled
    assert not tracing.enabled() and tracing.records() is not recorded
    spans = recorded.spans
    assert [span.name for span in spans] == ["update.load", "update.seed", "update"] * 2
    first, second = spans[:3], spans[3:]
    for group in (first, second):
        assert len({span.update for span in group}) == 1
        assert [span.parent for span in group] == ["update", "update", None]
        top = group[-1]
        assert all(top.start_ns <= span.start_ns <= span.end_ns <= top.end_ns for span in group)
        assert not any(span.profiled or span.device for span in group)
    assert first[0].update != second[0].update
    assert recorded.counter("load.skip") == 3 and recorded.counter("load.fill") == 1
    assert recorded.counter("load.copy") == 0
    assert recorded.sums[("update", False, False)][0] == 2 and recorded.host_mean_ns("update") > 0


def test_a_collecting_profiler_turns_the_tracer_on_until_stop(cpu_flagship):
    from torch.profiler import ProfilerActivity, profile

    state = cpu_flagship.init(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = _update(cpu_flagship, state, torch.tensor(0.01))
    names = {event.name for event in prof.events()}
    assert {"update", "update.load", "update.seed"} <= names
    assert tracing.enabled()  # stays on after the profiler stops
    _update(cpu_flagship, state, torch.tensor(0.02))
    tracing.stop()
    assert not tracing.enabled()
    _update(cpu_flagship, state, torch.tensor(0.03))
    recorded = tracing.records()
    assert recorded.sums[("update", False, True)][0] == 1  # profiled
    assert recorded.sums[("update", False, False)][0] == 1  # after the profiler, before stop()
    assert recorded.counter("load.skip", profiled=True) == 2 and recorded.counter("load.skip") == 2


def test_the_launch_registry_is_the_tracers_and_always_counts():
    assert build.LAUNCHES is tracing.LAUNCHES is cuda_rollout.LAUNCHES
    assert tuple(build.LAUNCHES) == build.KERNEL_SOURCES
    build.reset_launch_counts()
    assert not tracing.enabled()
    build.count_launch("rollout")
    with build.capture_tally() as tally:
        build.count_launch("rollout")
        build.count_launch("fp32_chain")
    assert tally == {
        "fused_sample_rollout": 0, "rollout": 1, "inkernel_rng_sample_rollout": 0, "fp32_chain": 1, "admm_qp": 0,
    }
    assert build.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 1, "inkernel_rng_sample_rollout": 0, "fp32_chain": 0, "admm_qp": 0,
    }
    tracing.reset()
    assert build.LAUNCHES["rollout"] == 1  # the tracer's reset leaves the registry
    assert tracing.records().counters == {}
    build.reset_launch_counts()


def _serving_tick(device, rollouts, steps, capture):
    flagship = build_flagship(rollouts, steps, device=device, scenarios=4)
    forecast = KalmanForecast(KalmanForecastConfiguration(
        horizon=steps * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    generator = torch.Generator(device=device).manual_seed(3)
    return flagship, forecast, make_serving_tick(flagship, forecast, 4, generator, capture=capture)


def test_a_captured_tick_copies_in_only_its_measurement(monkeypatch):
    """On a stand-in graph (the function rerun at each replay, as in
    test_torch_capture.py): given the states it returned, its own x buffer,
    a measurement and a number for the time, a captured tick makes one
    copy (the measurement) and one fill (the time), and skips the rest."""
    from test_torch_capture import _StandInGraph

    monkeypatch.setattr(graphs, "CapturedGraph", _StandInGraph)
    monkeypatch.setattr(graphs, "require_cuda", lambda device, what: None)
    monkeypatch.setattr(graphs, "_on_card", lambda value: isinstance(value, torch.Tensor))
    flagship, forecast, tick = _serving_tick("cpu", 14, 3, True)
    pushes = torch.zeros((4, 6))
    pushes[:, 0] = 20.0
    f_state, p_state, _, _ = tick(forecast.init(device="cpu"), flagship.init(0), flagship.x0, pushes[0], 0.01)
    x = tick.captured.x
    with tracing.collect() as recorded:
        for k in range(1, 4):
            f_state, p_state, _, _ = tick(f_state, p_state, x, pushes[k], 0.01 * (k + 1))
    assert recorded.sums[("serving_tick", False, False)][0] == 3
    assert recorded.counter("load.copy") == 3 and recorded.counter("load.fill") == 3
    assert recorded.counter("load.skip") == 3 * 3  # forecast state, planner state, x


class _Stamps:
    """A stand-in device timeline: its stamps (ns) fixed, finished or not."""

    def __init__(self, start_ns, names_and_ns, done=True):
        self.entry = "update"
        self.names = [name for name, _ in names_and_ns]
        self.stamps = [start_ns + ns for _, ns in names_and_ns]
        self.done = done

    def __len__(self):
        return len(self.names)

    def ran(self):
        pass

    def finished(self):
        return self.done

    def wait(self):
        self.done = True

    def read(self):
        return list(self.stamps)


def test_device_timelines_tile_each_update_and_give_the_idle_share():
    marks = [("planner.elite", 0), ("sampler.kernel", 250_000), ("planner.optimise", 750_000), (None, 1_000_000)]
    with tracing.collect() as recorded:
        for k in range(4):  # an update every 1.25 ms, each 1 ms on the device
            with tracing.span("update"), tracing.replaying(_Stamps(10_000_000 + 1_250_000 * k, marks)):
                pass
    assert recorded.timelines == {False: 4, True: 0}
    assert recorded.device_ns_per_update("update") == 1_000_000
    parts = sum(recorded.device_ns_per_update(name) for name in ("planner.elite", "sampler.kernel", "planner.optimise"))
    assert parts == 1_000_000 and recorded.device_ns_per_update("sampler.kernel") == 500_000
    assert recorded.device_idle() == pytest.approx(0.2)  # 3 x 0.25 idle in 3 x 1.25
    device = [span for span in recorded.spans if span.device]
    assert {span.update for span in device} == {span.update for span in recorded.spans if span.name == "update"}
    assert all(span.parent == "update" for span in device if span.name != "update")


def test_a_timeline_not_finished_waits_for_the_next_call_or_is_dropped_on_the_next_replay():
    line = _Stamps(5_000_000, [("planner.elite", 0), (None, 1_000_000)], done=False)
    with tracing.collect() as recorded:
        with tracing.span("update"), tracing.replaying(line):
            pass
        with tracing.span("update"):  # the next call finds it running: left pending
            pass
        assert recorded.timelines[False] == 0
        with tracing.span("update"), tracing.replaying(line):  # replayed again before it was read
            pass
        assert recorded.counter("device.dropped") == 1
        line.done = True
    assert recorded.timelines[False] == 1  # the last replay, read when collect() ends


def test_the_records_keep_the_spans_of_the_last_updates(monkeypatch):
    monkeypatch.setattr(tracing, "UPDATES_KEPT", 3)
    with tracing.collect() as recorded:
        for _ in range(5):
            with tracing.span("update"), tracing.span("update.load"):
                pass
    assert len(recorded.spans) == 6 and recorded.sums[("update", False, False)][0] == 5
    assert sorted({span.update for span in recorded.spans}) == [2, 3, 4]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _captured_updates(flagship, count, state=None, time=0.01):
    """``count`` captured updates, each followed by the control read."""
    state = flagship.init(7) if state is None else state
    ctx = flagship.make_ctx()
    for k in range(count):
        state, _ = flagship.update(state, flagship.x0, torch.tensor(time + 0.01 * k, device=flagship.x0.device), ctx)
        state.optimal_control[0].cpu()
    return state


def _check_tiling(recorded, names, entry="update"):
    whole = recorded.device_ns_per_update(entry)
    parts = sum(recorded.device_ns_per_update(name) or 0.0 for name in names)
    assert whole > 0 and abs(parts - whole) <= 0.01 * whole, (parts, whole)


@pytest.mark.gpu
def test_serve_capture_gains_at_most_ten_stamp_nodes_and_its_spans_tile_the_update(cuda):
    flagship = build_flagship(capture=True)
    state = _captured_updates(flagship, 3)
    graph = flagship.update.captured.graph
    assert 1 <= len(graph.timeline) <= 10
    assert graph.timeline.names[-1] is None
    with tracing.collect() as recorded:
        _captured_updates(flagship, 50, state, time=0.1)
    assert recorded.timelines[False] == 50 and recorded.counter("device.dropped") == 0, (
        recorded.timelines, recorded.counters)
    _check_tiling(recorded, SERVE_SPANS)
    assert recorded.counter("graph.replay.update") == 50
    assert recorded.counter("load.copy") + recorded.counter("load.fill") == 4 * 50
    # Against CUDA events around whole replays, queued behind a ~10 ms wait
    # on the device so that the graph's launch on the host is not timed.
    outer = []
    with tracing.collect() as recorded:
        for _ in range(50):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            begin.record()
            graph.replay()
            end.record()
            end.synchronize()
            outer.append(begin.elapsed_time(end) * 1e6)
    inner, outer = recorded.device_ns_per_update("update"), sum(outer) / len(outer)
    assert recorded.timelines[False] == 50 and 0.9 * outer <= inner <= outer, (recorded.timelines, inner, outer)


@pytest.mark.gpu
def test_safety_capture_gains_at_most_160_stamp_nodes_and_its_spans_tile_the_update(cuda):
    flagship = build_flagship(capture=True, safety=True)
    state = _captured_updates(flagship, 2)
    assert len(flagship.update.captured.graph.timeline) <= 160
    with tracing.collect() as recorded:
        _captured_updates(flagship, 3, state, time=0.1)
    _check_tiling(recorded, SAFETY_SPANS)
    filtered = sum(recorded.device_ns_per_update(name) for name in ("filter.model", "filter.qp", "plant.step"))
    assert filtered > 0.5 * recorded.device_ns_per_update("update")


@pytest.mark.gpu
def test_a_freed_graphs_last_replay_still_reads(cuda):
    flagship = build_flagship(rollouts=1022, steps=10, capture=True)
    state = _captured_updates(flagship, 2)
    with tracing.collect() as recorded:
        flagship.update(state, flagship.x0, torch.tensor(0.5, device=cuda), flagship.make_ctx())
        del flagship, state
        gc.collect()
        torch.cuda.empty_cache()
    assert recorded.timelines[False] == 1
    _check_tiling(recorded, SERVE_SPANS)


@pytest.mark.gpu
def test_the_serving_tick_spans_tile_the_captured_tick_and_it_copies_only_its_measurement(cuda):
    """The captured 10,000 x 50 x 4 serving tick: its device spans tile the
    tick; a tick given the states it returned, its own x buffer, a pinned
    measurement and a number for the time copies once and fills once; one
    launch of kernel 2 a tick and none of kernel 1."""
    flagship, forecast, tick = _serving_tick(cuda, 10_000 - 2, 50, True)
    pushes = torch.zeros((51, 6)).pin_memory()
    pushes[:, 0] = 20.0
    f_state, p_state, _, _ = tick(forecast.init(device=cuda), flagship.init(7), flagship.x0, pushes[0], 0.01)
    x = tick.captured.x
    build.reset_launch_counts()
    with tracing.collect() as recorded:
        for k in range(1, 51):
            f_state, p_state, _, _ = tick(f_state, p_state, x, pushes[k], 0.01 * (k + 1))
            p_state.optimal_control[0].cpu()
    assert recorded.timelines[False] == 50 and recorded.counter("device.dropped") == 0, (
        recorded.timelines, recorded.counters)
    _check_tiling(recorded, TICK_SPANS, entry="serving_tick")
    assert recorded.counter("graph.replay.serving_tick") == 50
    assert recorded.counter("load.copy") == 50 and recorded.counter("load.fill") == 50
    assert build.LAUNCHES["rollout"] == 50 and build.LAUNCHES["fused_sample_rollout"] == 0
