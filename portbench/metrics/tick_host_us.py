"""``tick_host_us`` (us per tick): the mean host time of the port's
``serving_tick`` span, the call into the captured serving tick from its
first line to the return (loading the inputs, splitting the planner's key,
seeding the replay, launching the graph), over the ticks recorded without
the profiler."""

from portbench import spans


def read(trace):
    recorded = spans.records()
    value = recorded.host_mean_ns("serving_tick") if recorded is not None else None
    return None if value is None else value / 1e3
