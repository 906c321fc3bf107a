"""``tick_load_copies`` (copies per tick): the port's counters ``load.copy``
and ``load.fill`` (an input copied or a number filled into the captured
tick's input buffers) over its ``graph.replay.serving_tick`` counter, over
the ticks recorded without the profiler."""

from portbench import spans


def read(trace):
    recorded = spans.records()
    if recorded is None:
        return None
    replays = recorded.counter("graph.replay.serving_tick")
    if not replays:
        return None
    return (recorded.counter("load.copy") + recorded.counter("load.fill")) / replays
