"""A ``torch.profiler`` window over steady cycles, reduced to what the
per-layer metric readers (``portbench/metrics/<name>.py``) read.

``Trace`` holds the device operations (kernels, copies, memsets: each CUPTI
activity on the card) and the host events (CUDA runtime calls, PyTorch
operators and the benchmark's own spans) of the window, with their start
and end in microseconds on the profiler's clock, the number of cycles the
window covers and its length by the host's clock. The arithmetic follows
``scripts/torch_profile_update.py`` (the device-operation count, the
launch-call names, the busy share), copied here so that the yardstick does
not move with the scripts."""

from __future__ import annotations

import dataclasses

import torch

# Host calls that put work on the device: a graph launch counts one.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy")
# The profiler's own host events: a gap they cover is the profiler's cost.
PROFILER_EVENTS = ("Buffer Flush", "Activity Buffer Request")


@dataclasses.dataclass
class Trace:
    cycles: int
    window_s: float
    device_ops: list  # [(name, start_us, end_us)]
    host_ops: list  # [(name, start_us, end_us)]
    config: dict

    def device_intervals(self) -> list:
        """The device operations' intervals, overlapping ones merged."""
        merged = []
        for _, start, end in sorted(self.device_ops, key=lambda op: op[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self) -> float:
        return sum(end - start for start, end in self.device_intervals()) / 1e6

    def per_cycle(self, value: float) -> float:
        return value / self.cycles

    def launch_calls(self) -> dict:
        """Host launch calls per cycle, by name."""
        counts = {}
        for name, _, _ in self.host_ops:
            if name in LAUNCH_CALLS:
                counts[name] = counts.get(name, 0) + 1
        return {name: count / self.cycles for name, count in sorted(counts.items())}


def from_profiler(prof, cycles: int, window_s: float, config: dict) -> Trace:
    device, host = [], []
    for event in prof.events():
        span = (event.name, event.time_range.start, event.time_range.end)
        if event.device_type != torch.autograd.DeviceType.CUDA:
            host.append(span)
        elif not event.is_user_annotation:  # a span's shadow on the device's timeline is no operation
            device.append(span)
    return Trace(cycles, window_s, device, host, config)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time over the window, by name,
    and the longest idle gaps of the device, each named by what the host
    was doing at its middle (the innermost host event there)."""
    by_name = {}
    for name, start, end in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda item: -item[1])[:10]
    intervals = trace.device_intervals()
    gaps = [(intervals[i][1], intervals[i + 1][0]) for i in range(len(intervals) - 1)]
    gaps = sorted(gaps, key=lambda gap: gap[0] - gap[1])[:10]
    named = []
    for start, end in gaps:
        middle = (start + end) / 2
        covering = [op for op in trace.host_ops if op[1] <= middle <= op[2]]
        ours = [op for op in covering if op[0] not in PROFILER_EVENTS]
        if ours or covering:
            label = min(ours or covering, key=lambda op: op[2] - op[1])[0]
        else:
            label = "host: no profiled call"
        named.append([label, (end - start) / 1e6])
    return {"device_ops": [[name[:120], seconds] for name, seconds in ops], "idle_gaps": named}
