"""``device_ops`` (operations per cycle): the device operations (kernels,
copies, memsets) the trace holds, per cycle: a captured update's graph
nodes, and the cycle's own copies."""


def read(trace):
    if not trace.device_ops:
        return None
    return trace.per_cycle(float(len(trace.device_ops)))
