"""The readers of the port's own spans and counters (``portbench/spans.py``,
the per-layer metrics of source ``program_span`` and ``program_counter``):
None where the program has no tracer, or where it recorded nothing; a
reading where it recorded updates without the profiler."""

import builtins
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = [m["name"] for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")]


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_the_tracer_readers_are_found():
    assert len(READERS) == 12 and "update_device_ms" in READERS and "load_copies" in READERS


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_on_empty_records(name):
    from assistedmanipulation_tpu_torch import tracing

    tracing.reset()
    assert _reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_without_the_tracer(name, monkeypatch):
    real_import = builtins.__import__

    def no_tracer(module, globals=None, locals=None, fromlist=(), level=0):
        if module == "assistedmanipulation_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("cannot import name 'tracing'")
        return real_import(module, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert _reader(name).read(None) is None


def test_readers_read_the_updates_recorded_without_the_profiler():
    from assistedmanipulation_tpu_torch import tracing

    tracing.reset()
    with tracing.collect() as recorded:
        with tracing.span("update"):
            tracing.count("load.copy", 3)
            tracing.count("load.fill")
            tracing.count("graph.replay.update")
    recorded.add(tracing.Span("update", 0, 2_000_000, None, 9, False, True))
    recorded.add(tracing.Span("planner.elite", 0, 500_000, "update", 9, False, True))
    recorded.add(tracing.Span("planner.elite", 0, 900_000, "update", 10, True, True))  # profiled: not read
    recorded.timelines[False] = 1
    tracing._records = recorded
    try:
        assert _reader("load_copies").read(None) == 4
        assert _reader("elite_device_ms").read(None) == pytest.approx(0.5)
        assert _reader("update_device_ms").read(None) == pytest.approx(2.0)
        assert _reader("entry_host_us").read(None) > 0
        assert _reader("filter_qp_device_ms").read(None) is None
        assert _reader("device_idle_spans").read(None) is None  # one update: no time between starts
    finally:
        tracing.reset()
