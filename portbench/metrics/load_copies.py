"""``load_copies`` (copies per update): the port's counters ``load.copy``
and ``load.fill`` (an input copied or a number filled into a captured
graph's static buffer, ``graphs.load``) over its ``graph.replay.*``
counters, over the updates recorded without the profiler."""

from portbench import spans


def read(trace):
    recorded = spans.records()
    if recorded is None:
        return None
    replays = recorded.counter_prefix("graph.replay.")
    if not replays:
        return None
    return (recorded.counter("load.copy") + recorded.counter("load.fill")) / replays
