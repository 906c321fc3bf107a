"""``entry_host_us`` (us per update): the mean host time of the port's
``update`` span, the call into the captured update from its first line to
the return (loading the inputs, splitting the key, seeding the replay,
launching the graph), over the updates recorded without the profiler."""

from portbench import spans


def read(trace):
    recorded = spans.records()
    value = recorded.host_mean_ns("update") if recorded is not None else None
    return None if value is None else value / 1e3
