"""``nonkernel_device_ms`` (ms per cycle): device time outside the rollout
kernels (``pair_sample_rollout_kernel``, kernels 1 and 3, and
``pair_rollout_kernel``, kernel 2): the planner's own operations, the
smoothing, the safety filter and the plant, and the copies."""

ROLLOUT_KERNELS = ("pair_sample_rollout_kernel", "pair_rollout_kernel")


def read(trace):
    if not trace.device_ops:
        return None
    seconds = sum(
        end - start for name, start, end in trace.device_ops if not any(k in name for k in ROLLOUT_KERNELS)
    ) / 1e6
    return 1e3 * trace.per_cycle(seconds)
