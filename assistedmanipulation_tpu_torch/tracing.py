"""Spans and counters inside the port: where an update's host and device time
goes, layer by layer.

Off by default. While off, ``span`` returns one shared no-op, ``count``
returns at once and ``mark`` records nothing outside a capture: no clock
read, no allocation, no ``record_function``. The tracer turns on in two
ways only:

- the first time a port span finds a ``torch.profiler`` session collecting
  (``profiler_collecting``). It then stays on for the rest of the process,
  or until ``stop()``: the updates after the profiled ones are recorded
  without the profiler, so their readings carry none of its cost. Every
  record says whether a profiler was collecting (``profiled``);
- ``with collect() as rec:``, the operator's switch: ``rec`` holds what the
  block recorded (``rec.spans``, ``rec.counters``, the sums), device spans
  included, read when the block ends.

**Host spans** (``with span(name):``) record the name, start and end
(``time.perf_counter_ns``), the parent span's name and the update's
identifier, shared by every span of one call into the port (a span with no
parent starts a new one). While a profiler collects, a span is also entered
as ``torch.profiler.record_function(name)``, so it lands in the profiler's
trace on the profiler's clock.

**Device spans** (``mark(name)``): a one-thread kernel on the current
stream writes the device's global timer (ns, the timebase the CUDA profiler
stamps device operations with) into the timeline's next slot; each stamp
opens the span ``name`` and closes the one before it, so the spans of one
timeline tile it, and its last stamp closes the whole, named by its entry
(``update``, ``serving_tick``, ``episode``). In a CUDA graph capture
(``timeline(entry, captured=True)``, ``graphs.CapturedGraph``) a mark is a
kernel node of the graph, captured whatever the tracer's state (a timing
event's record node would cost ~5x as much, ``kernels/csrc/timer.cu``);
eagerly it stamps only while the tracer is on. A replay's or an eager
update's stamps are read at the port's next call (a span with no parent)
once the stream has finished them, or by ``records()``, which waits for
them. A graph replayed again before its last replay was read loses that
replay's reading (counter ``device.dropped``). The tracer holds the slots,
so a timeline reads after its graph is freed.

**Counters** count only while the tracer is on (``count``), except the
kernel-launch registry ``LAUNCHES``, which always counts (see
``count_launch``; ``kernels/build.LAUNCHES`` is the same dict).

Records are kept in memory: sums and counts per (name, device, profiled),
counters per (name, profiled), and the raw spans of the last
``UPDATES_KEPT`` updates. One thread drives the port at a time.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# Raw spans are kept for this many of the most recent updates.
UPDATES_KEPT = 4096
# Timelines waiting to be read; beyond this many the oldest is
# dropped (a caller that never lets the device catch up).
PENDING_KEPT = 64

# Kernel launches by library, counted by each wrapper where it launches (and
# nowhere else); ``kernels/build.py`` names the libraries. A wrapper called
# while a CUDA graph is captured launches nothing: its count goes to the
# capture's tally, and each replay of the graph adds the tally here
# (graphs.CapturedGraph). Counts whether or not the tracer is on.
LAUNCHES: dict = {}
_capture_tally = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel, or one kernel node of the graph
    being captured."""
    if _capture_tally is not None:
        _capture_tally[name] += 1
    else:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def capture_tally():
    """Within the block, ``count_launch`` tallies the kernel nodes of the
    graph being captured instead of launches; yields the tally."""
    global _capture_tally
    if _capture_tally is not None:
        raise RuntimeError("a capture is already being tallied")
    _capture_tally = {name: 0 for name in LAUNCHES}
    try:
        yield _capture_tally
    finally:
        _capture_tally = None


def profiler_collecting() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) session is
    collecting: the one place that reads PyTorch's private flag."""
    flag = _autograd_profiler._is_profiler_enabled
    return bool(flag() if callable(flag) else flag)


class Span(NamedTuple):
    name: str
    start_ns: int  # host: perf_counter_ns; device: the device's global timer
    end_ns: int
    parent: Optional[str]
    update: int
    profiled: bool
    device: bool = False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Records:
    """What the tracer recorded: ``sums[(name, device, profiled)] = [count,
    total ns]``, ``counters[(name, profiled)]``, ``timelines[profiled]``
    (device timelines read, one per timed update) and the raw ``spans`` of
    the last ``UPDATES_KEPT`` updates."""

    def __init__(self):
        self.sums: dict = {}
        self.counters: dict = {}
        self.timelines = {False: 0, True: 0}
        # [busy ns, ns between successive timeline starts] over timelines
        # read one after another.
        self.between = {False: [0, 0], True: [0, 0]}
        self._previous = None  # (profiled, start ns, whole ns) of the last timeline read
        self._updates: collections.OrderedDict = collections.OrderedDict()

    @property
    def spans(self) -> list:
        return [span for group in self._updates.values() for span in group]

    def add(self, span: Span) -> None:
        total = self.sums.setdefault((span.name, span.device, span.profiled), [0, 0])
        total[0] += 1
        total[1] += span.ns
        group = self._updates.get(span.update)
        if group is None:
            group = self._updates[span.update] = []
            if len(self._updates) > UPDATES_KEPT:
                self._updates.popitem(last=False)
        group.append(span)

    def count(self, name: str, profiled: bool, n: int = 1) -> None:
        key = (name, profiled)
        self.counters[key] = self.counters.get(key, 0) + n

    def counter(self, name: str, profiled: bool = False) -> int:
        return self.counters.get((name, profiled), 0)

    def counter_prefix(self, prefix: str, profiled: bool = False) -> int:
        """The sum of the counters whose name starts with ``prefix``."""
        return sum(n for (name, p), n in self.counters.items() if p == profiled and name.startswith(prefix))

    def host_mean_ns(self, name: str, profiled: bool = False) -> Optional[float]:
        """The mean of the host span ``name``, or None if none was recorded."""
        count, total = self.sums.get((name, False, profiled), (0, 0))
        return total / count if count else None

    def device_ns_per_update(self, name: str, profiled: bool = False) -> Optional[float]:
        """The device span ``name`` summed over each timed update (a span
        that a timeline holds many times, such as a plant step, counts every
        time), averaged over the timed updates; None if no update was timed
        or none held the span."""
        updates = self.timelines[profiled]
        count, total = self.sums.get((name, True, profiled), (0, 0))
        return total / updates if updates and count else None

    def device_idle(self, profiled: bool = False) -> Optional[float]:
        """The share of the time between successive timeline starts in
        which no timeline ran; None before two successive timelines."""
        busy, between = self.between[profiled]
        return 1.0 - busy / between if between > 0 else None

    def _timeline(self, profiled: bool, start_ns: int, whole_ns: int) -> None:
        self.timelines[profiled] += 1
        previous = self._previous
        if previous is not None and previous[0] == profiled and start_ns > previous[1]:
            self.between[profiled][0] += previous[2]
            self.between[profiled][1] += start_ns - previous[1]
        self._previous = (profiled, start_ns, whole_ns)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()

_on = False  # the switch every span, count and eager mark tests first
_records = Records()
_stack: list = []  # the open host spans, innermost last
_next_update = 0
_pending: list = []  # (Timeline, update, profiled, Records) not read yet
_timing = None  # the Timeline a capture or an eager update is stamping
_timer = None  # the stamp kernel's library (kernels/csrc/timer.cu), loaded at the first timeline


class _Span:
    __slots__ = ("name", "start", "parent", "update", "profiled", "function")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_update
        if _stack:
            parent = _stack[-1]
            self.parent, self.update, self.profiled = parent.name, parent.update, parent.profiled
        else:
            self.parent, self.update, self.profiled = None, _next_update, profiler_collecting()
            _next_update += 1
        self.function = None
        if self.profiled:
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        if self.parent is None and _pending:
            _read_pending_at_call(self.profiled)
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack.pop()
        if self.function is not None:
            self.function.__exit__(*exc)
        _records.add(Span(self.name, self.start, end, self.parent, self.update, self.profiled))
        return False


def enabled() -> bool:
    return _on


def span(name: str):
    """``with span(name):`` a host span (see the module); a shared no-op
    while the tracer is off and no profiler collects."""
    global _on
    if not _on:
        if not profiler_collecting():
            return _NO_SPAN
        _on = True
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not _on:
        return
    _records.count(name, _stack[-1].profiled if _stack else profiler_collecting(), n)


def clock() -> Optional[int]:
    """``perf_counter_ns`` while the tracer is on, else None (no clock read):
    the start of a wait that ``count_since`` counts."""
    return time.perf_counter_ns() if _on else None


def count_since(name: str, started: Optional[int]) -> None:
    """One more ``name`` and the ns since ``started`` (from ``clock``) on
    ``name.ns``; nothing when ``started`` is None."""
    if started is None:
        return
    elapsed = time.perf_counter_ns() - started
    count(name)
    count(name + ".ns", elapsed)


def mark(name: str) -> None:
    """Open the device span ``name`` here on the current stream, closing the
    one before it (see the module)."""
    if _timing is None:
        return
    _timing.stamp(name)


def _stamp_kernel():
    global _timer
    if _timer is None:
        import ctypes

        from .kernels import build

        library = build.load("timer")
        library.tm_stamp.restype = ctypes.c_int
        library.tm_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _timer = library
    return _timer


class Timeline:
    """The device stamps of one captured graph or one eager update: a
    one-thread kernel (``kernels/csrc/timer.cu``) per mark writes the
    device's global timer (ns) into the next of ``SLOTS`` slots, in pinned
    host memory that the host reads without a copy; ``names[i]`` is the
    span that slot ``i`` opens, None for the last (the end). The slots are
    made, and a captured graph's kernel loaded and launched once, before
    any capture: nothing is allocated while capturing. Past the slots, marks
    are left out and the span open then runs to the end."""

    SLOTS = 4096

    def __init__(self, entry: str, device):
        self.entry = entry
        self.device = torch.device(device)
        self.names: list = []
        self._slots = torch.zeros(self.SLOTS, dtype=torch.int64, pin_memory=True)
        self._done = None  # an event recorded after its last run

    def __len__(self) -> int:
        return len(self.names)

    def warm_up(self) -> None:
        """Load and launch the kernel once (into the slot the first mark
        overwrites): before a capture, which must not be its first launch."""
        self._launch(0)

    def _launch(self, index: int) -> None:
        stream = torch.cuda.current_stream(self.device)
        error = _stamp_kernel().tm_stamp(self._slots.data_ptr(), index, stream.cuda_stream)
        if error != 0:
            raise RuntimeError(f"the tracer's stamp failed: CUDA error {error}")

    def stamp(self, name) -> None:
        if name is not None and len(self.names) >= self.SLOTS - 1:
            return
        self._launch(len(self.names))
        self.names.append(name)

    def ran(self) -> None:
        """Its run (an eager update, or a replay) was just issued to the
        current stream: an event after it tells when it has finished (and
        with it, that its stamps are visible to the host)."""
        if self._done is None:
            self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(self.device))

    def finished(self) -> bool:
        """Whether its last run has finished, without waiting."""
        return self._done is None or self._done.query()

    def wait(self) -> None:
        """Wait until its last run has finished."""
        if self._done is not None:
            self._done.synchronize()

    def read(self) -> list:
        """The stamps (ns) of its last run, in order (once it has finished)."""
        return self._slots[: len(self.names)].tolist()


def timeline(entry: str, device=None, captured: bool = False):
    """``with timeline(entry, ...) as line:`` the device timeline of the
    block on a CUDA ``device`` (the current one by default): ``captured``
    (the block is a CUDA graph capture; call this before the capture starts)
    always; eagerly only while the tracer is on, and when no timeline is open
    already (an inner update of an eager tick times into the tick's).
    Otherwise a shared no-op."""
    if captured:
        line = Timeline(entry, device if device is not None else torch.cuda.current_device())
        line.warm_up()
        return _Timing(line, True)
    if not _on or _timing is not None or torch.device(device).type != "cuda":
        return _NO_SPAN
    return _Timing(Timeline(entry, device), False)


class _Timing:
    __slots__ = ("line", "captured", "saved")

    def __init__(self, line: Timeline, captured: bool):
        self.line, self.captured = line, captured

    def __enter__(self) -> Timeline:
        global _timing
        self.saved = _timing
        _timing = self.line
        return self.line

    def __exit__(self, kind, *exc) -> bool:
        global _timing
        try:
            if kind is None and self.line.names:
                mark(None)
        finally:
            _timing = self.saved
        if kind is None and not self.captured and self.line.names:
            _pend(self.line)
        return False


def replaying(line: Optional[Timeline]):
    """Around one replay of the graph whose captured timeline is ``line``:
    while the tracer is on, its stamps are read after the replay (the last
    replay's reading first, if the port has not read it yet). Otherwise a
    shared no-op."""
    if not _on or not line:
        return _NO_SPAN
    return _Replaying(line)


class _Replaying:
    __slots__ = ("line",)

    def __init__(self, line: Timeline):
        self.line = line

    def __enter__(self):
        for item in list(_pending):
            if item[0] is self.line:
                _pending.remove(item)
                _read(item, block=False)
        return self

    def __exit__(self, kind, *exc) -> bool:
        if kind is None:
            _pend(self.line)
        return False


def _pend(line: Timeline) -> None:
    top = _stack[0] if _stack else None
    profiled = top.profiled if top is not None else profiler_collecting()
    line.ran()
    _pending.append((line, top.update if top is not None else -1, profiled, _records))
    if len(_pending) > PENDING_KEPT:
        _drop(_pending.pop(0))


def _drop(item) -> None:
    item[3].count("device.dropped", item[2])
    item[3]._previous = None


def _read_pending(block: bool) -> None:
    while _pending:
        if not block and not _pending[0][0].finished():
            return
        _read(_pending.pop(0), block)


def _read_pending_at_call(profiled: bool) -> None:
    """Read the finished timelines at the start of a call into the port,
    under the profiler as ``tracing.read`` inside the call's span; its count
    and ns are the counters ``tracing.read`` and ``tracing.read.ns`` (the
    tracer's own cost, left out of the call's span's own time)."""
    started = time.perf_counter_ns()
    if profiled:
        with torch.profiler.record_function("tracing.read"):
            _read_pending(block=False)
    else:
        _read_pending(block=False)
    count_since("tracing.read", started)


def _read(item, block: bool) -> None:
    """Read one run's stamps into its records (``block``: waiting for the
    run; else a run not finished is dropped)."""
    line, update, profiled, records = item
    if block:
        line.wait()
    elif not line.finished():
        _drop(item)
        return
    stamps = line.read()
    for name, begin, end in zip(line.names, stamps, stamps[1:]):
        records.add(Span(name, begin, end, line.entry, update, profiled, True))
    records.add(Span(line.entry, stamps[0], stamps[-1], None, update, profiled, True))
    records._timeline(profiled, stamps[0], stamps[-1] - stamps[0])


def records() -> Records:
    """The tracer's records, every device timeline read (waiting for the
    device where it has not finished)."""
    _read_pending(block=True)
    return _records


def stop() -> None:
    """Read what is pending and turn the tracer off; the records stay."""
    global _on
    _read_pending(block=True)
    _on = False


def reset() -> None:
    """Forget every record and turn the tracer off (``LAUNCHES`` stays)."""
    global _on, _records, _next_update
    _pending.clear()
    _on, _records, _next_update = False, Records(), 0


@contextlib.contextmanager
def collect():
    """``with collect() as rec:``: the tracer on for the block, recording
    into a fresh ``Records`` that the block's device timelines are read into
    when it ends; then the tracer's state before the block returns."""
    global _on, _records
    _read_pending(block=True)
    saved = (_on, _records)
    _on, _records = True, Records()
    try:
        yield _records
    finally:
        _read_pending(block=True)
        _on, _records = saved
