"""``device_idle_spans`` (%): 1 - the device time of the port's ``update``
spans over the device time between the starts of successive updates, from
the updates recorded without the profiler: the device's idle share in the
closed loop, free of the profiler's cost (``device_idle`` reads it under
the profiler)."""

from portbench import spans


def read(trace):
    recorded = spans.records()
    value = recorded.device_idle() if recorded is not None else None
    return None if value is None else 100.0 * value
