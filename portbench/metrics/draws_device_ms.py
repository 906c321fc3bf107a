"""``draws_device_ms`` (ms per update): the port's device span
``sampler.draws``: the sampler around its rollout kernel: the kernel's
inputs, the fresh draws, the noise assembly and the joined outputs; read
from the updates recorded without the profiler."""

from portbench import spans


def read(trace):
    return spans.device_ms("sampler.draws")
