"""``tick_device_ms`` (ms per tick): the port's device span
``serving_tick``: the whole captured serving tick, from its first mark
(the forecast's) to the graph's last node, after the write-back of the
forecast and planner states; read from the ticks recorded without the
profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("serving_tick")
