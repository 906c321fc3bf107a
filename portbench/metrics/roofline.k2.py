"""``roofline.k2`` (%): kernel 2's share of its roofline at the
configuration's scenario count, the least time the chip could take for
one launch at the configuration's shapes (``portbench/roofline_k2.py``)
over the kernel's measured device time per cycle in the trace. None where
the trace holds no launch of it."""

from portbench import roofline, roofline_k2


def read(trace):
    scenarios = int(trace.config.get("flagship", {}).get("scenarios", 1))
    kernel = f"pair_rollout_kernel<{scenarios}>"
    seconds = sum(end - start for name, start, end in trace.device_ops if kernel in name) / 1e6
    if seconds <= 0:
        return None
    mppi = trace.config["mppi"]
    rollouts = int(mppi["rollouts"]) + 2
    steps = int(round(mppi["horizon"] / mppi["time_step"]))
    least = roofline.least_seconds(roofline_k2.kernel2_flops(rollouts, steps, scenarios),
                                   roofline_k2.kernel2_bytes(rollouts, steps, scenarios))
    return 100.0 * least / trace.per_cycle(seconds)
