"""``roofline.k1`` (%): kernel 1's share of its roofline, the least time
the chip could take for one launch at the configuration's shapes
(``portbench/roofline.py``) over the kernel's measured device time per
cycle in the trace. None where the trace holds no launch of it."""

from portbench import roofline

KERNEL = "pair_sample_rollout_kernel<false>"


def read(trace):
    seconds = sum(end - start for name, start, end in trace.device_ops if KERNEL in name) / 1e6
    if seconds <= 0:
        return None
    mppi = trace.config["mppi"]
    rollouts = int(mppi["rollouts"]) + 2
    steps = int(round(mppi["horizon"] / mppi["time_step"]))
    least = roofline.least_seconds(roofline.kernel1_flops(rollouts, steps), roofline.kernel1_bytes(rollouts, steps))
    return 100.0 * least / trace.per_cycle(seconds)
