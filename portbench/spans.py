"""The port's own spans and counters (``assistedmanipulation_tpu_torch.tracing``),
as the per-layer readers ``portbench/metrics/<name>.py`` of source
``program_span`` and ``program_counter`` read them.

A ``--trace 1`` run profiles its first traced cycles; the port's tracer turns
on at the first of them and stays on through the untraced window after, so
these readers read the cycles recorded without the profiler (``profiled``
False), free of its cost. Each returns None where the program has no tracer
(it predates it) or recorded nothing."""

from __future__ import annotations


def records():
    """The tracer's records, or None."""
    try:
        from assistedmanipulation_tpu_torch import tracing
    except ImportError:
        return None
    recorded = tracing.records()
    return recorded if recorded.sums or recorded.counters else None


def device_ms(name: str):
    """The device span ``name`` in ms per timed update (summed over the
    update), or None."""
    recorded = records()
    value = recorded.device_ns_per_update(name) if recorded is not None else None
    return None if value is None else value / 1e6
