"""``launch_calls`` (calls per cycle): the host's CUDA runtime calls that
put work on the device (``portbench.trace.LAUNCH_CALLS``): a graph launch
counts one, and so does each eager copy, such as the control read."""

def read(trace):
    calls = trace.launch_calls()
    return sum(calls.values()) if calls else None
