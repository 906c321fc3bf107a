"""``optimise_device_ms`` (ms per update): the port's device span
``planner.optimise``: _optimise without SG: the weights, the weighted noise
sum, the gradient step, the clamp and the degenerate select; read from the
updates recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("planner.optimise")
