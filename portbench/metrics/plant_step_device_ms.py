"""``plant_step_device_ms`` (ms per update): the port's device span
``plant.step``: the plant's step in the re-rollout (derive, cost,
integrate), summed over the steps; read from the updates recorded without
the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("plant.step")
