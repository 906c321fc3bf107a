"""``sg_device_ms`` (ms per update): the port's device span ``planner.sg``: the
Savitzky-Golay smoothing (sg_smooth) inside _optimise; read from the updates
recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("planner.sg")
