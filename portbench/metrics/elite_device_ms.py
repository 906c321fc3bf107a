"""``elite_device_ms`` (ms per update): the port's device span
``planner.elite``: the elite selection: the horizon shift and the elite
lexsort (or threshold select) of _sample_meta; read from the updates
recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("planner.elite")
