"""``device_idle`` (%): the share of the traced window, by the host's
clock, in which the device runs no operation."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
