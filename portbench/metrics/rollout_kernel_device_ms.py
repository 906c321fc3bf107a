"""``rollout_kernel_device_ms`` (ms per update): the port's device span
``sampler.kernel``: the rollout kernel's launch alone (kernel 1, 2 or 3);
read from the updates recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("sampler.kernel")
