"""``update_device_ms`` (ms per update): the port's device span ``update``: the
whole captured update, from its first mark to the graph's last node, after
the write-back of the state; read from the updates recorded without the
profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("update")
