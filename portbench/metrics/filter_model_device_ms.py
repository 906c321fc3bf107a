"""``filter_model_device_ms`` (ms per update): the port's device span
``filter.model``: the safety filter's model at each re-rollout step (FK,
mass matrix, factorisation, constraint rows), summed over the steps; read
from the updates recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("filter.model")
