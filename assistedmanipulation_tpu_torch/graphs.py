"""CUDA-graph capture of the port's device work: the counterpart of the JAX
package's ``jax.jit(self._update_impl, donate_argnums=0)`` (one compiled
program per update, assistedmanipulation_tpu/mppi.py:328).

``CapturedGraph`` records one call of a function on static input buffers as
a ``torch.cuda.CUDAGraph`` and replays it: one graph launch in place of the
hundreds of eager launches of an update. What varies from replay to replay
reaches the graph through three doors only:

- the static input buffers, which ``load`` fills from the caller's values
  before a replay (device-to-device copies, or a fill for a number);
- generators registered with the graph, seeded on the host before a replay:
  a replay then draws what an eager call under the same seed draws;
- ``HostInput``: a pinned host buffer that the graph copies to the device
  as it runs.

Capture is for CUDA only (``require_cuda`` raises by name elsewhere), and
nothing falls back to eager: an operation the capture cannot take fails the
capture. Launch counts follow the graph: a wrapper called during capture
tallies its kernel node (``build.capture_tally``), and each replay adds the
tally to ``build.LAUNCHES``. The tracer (``tracing``) sees a capture and each
replay as host spans and counters by the graph's entry, and the device
spans marked in the captured function as the graph's own stamp nodes.
"""

from __future__ import annotations

import torch

from . import tracing
from .kernels import build


class _GraphSeed:
    def __repr__(self) -> str:
        return "GRAPH_SEED"


# Passed as an update's seed words inside a capture: the sampler draws from
# its registered generator (or the seed words' HostInput), seeded on the
# host before each replay, instead of seeding from words it is given.
GRAPH_SEED = _GraphSeed()


def require_cuda(device, what: str) -> None:
    if torch.device(device).type != "cuda":
        raise RuntimeError(
            f"{what} captures a CUDA graph and needs a CUDA device, not {device}; "
            "the eager path runs anywhere"
        )


def _is_tuple(value) -> bool:
    return isinstance(value, tuple) and hasattr(value, "_fields")


def _on_card(value) -> bool:
    return isinstance(value, torch.Tensor) and value.device.type == "cuda"


def static_copy(tree):
    """A (nested) NamedTuple like ``tree`` with every CUDA tensor cloned:
    buffers a graph can own. Host tensors and other leaves are kept."""
    if _is_tuple(tree):
        return type(tree)(*(static_copy(value) for value in tree))
    return tree.clone() if _on_card(tree) else tree


def load(static, value, name: str = "input") -> None:
    """Copy ``value`` into the static buffers ``static`` of the same
    structure: a CUDA buffer takes a tensor of its shape (converted to its
    dtype) or a number; a buffer given as its own value is left alone. Other
    leaves (host tensors, floats, None) were fixed at capture: a float or
    None that differs raises, host tensors are not read."""
    if _is_tuple(static):
        if not _is_tuple(value) or value._fields != static._fields:
            raise TypeError(f"{name}: expected a {type(static).__name__}, got {type(value).__name__}")
        for field, s, v in zip(static._fields, static, value):
            load(s, v, f"{name}.{field}")
    elif _on_card(static):
        if isinstance(value, torch.Tensor):
            if value is static:
                tracing.count("load.skip")
                return
            if value.shape != static.shape:
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} differs from the captured {tuple(static.shape)}"
                )
            static.copy_(value)
            tracing.count("load.copy")
        else:
            static.fill_(value)
            tracing.count("load.fill")
    elif not isinstance(static, torch.Tensor) and not (
        static is value or (static is not None and value is not None and static == value)
    ):
        raise ValueError(f"{name}: {value!r} differs from the captured {static!r}")


def write_back(static, new) -> None:
    """Copy ``new``'s CUDA tensors into ``static``'s buffers of the same
    structure (inside a capture: the graph's outputs become its next
    inputs)."""
    if _is_tuple(static):
        for s, n in zip(static, new):
            write_back(s, n)
    elif _on_card(static) and static is not new:
        static.copy_(new)


class HostInput:
    """A pinned host buffer that a captured graph copies to a device buffer
    each time it is replayed. ``write`` fills it before a replay, first
    waiting until the last replay has copied it out; ``load`` is the copy,
    called in the captured function."""

    def __init__(self, shape, dtype, device):
        self.host = torch.zeros(shape, dtype=dtype).pin_memory()
        self.device = torch.zeros(shape, dtype=dtype, device=device)
        self._read = torch.cuda.Event()

    def write(self, value: torch.Tensor) -> None:
        started = tracing.clock()
        self._read.synchronize()
        tracing.count_since("host_input.wait", started)
        self.host.copy_(value)

    def load(self) -> torch.Tensor:
        return self.device.copy_(self.host, non_blocking=True)

    def mark_read(self) -> None:
        """Called after each replay that copies the buffer."""
        self._read.record()


class CapturedGraph:
    """``fn()`` captured once as a CUDA graph; ``replay()`` runs it again
    and returns the outputs of the capture, rewritten in place.

    ``generators``: the generators ``fn`` draws from, registered with the
    graph; ``host_inputs``: the ``HostInput`` buffers ``fn`` loads. Run
    ``fn`` eagerly at least once before: the capture must not be the first
    call of anything (kernel builds, library workspaces, lazy loading).

    ``entry`` names the graph in the tracer's records: its whole device
    span (``tracing.mark`` in ``fn`` bounds the spans inside it; the graph's
    last node closes it) and its counters ``graph.capture.<entry>`` and
    ``graph.replay.<entry>``."""

    def __init__(self, fn, generators=(), host_inputs=(), entry: str = "graph"):
        self._replay_counter = "graph.replay." + entry
        self.graph = torch.cuda.CUDAGraph()
        registered = []
        for generator in generators:
            if not any(generator is other for other in registered):
                self.graph.register_generator_state(generator)
                registered.append(generator)
        self._host_inputs = tuple(host_inputs)
        with tracing.span("graph.capture"), build.capture_tally() as tally:
            tracing.count("graph.capture." + entry)
            timing = tracing.timeline(entry, captured=True)
            with torch.cuda.graph(self.graph), timing as self.timeline:
                self.outputs = fn()
        self.launches = {name: count for name, count in tally.items() if count}

    def replay(self):
        with tracing.span("graph.replay"):
            tracing.count(self._replay_counter)
            with tracing.replaying(self.timeline):
                self.graph.replay()
            for host_input in self._host_inputs:
                host_input.mark_read()
            for name, count in self.launches.items():
                build.LAUNCHES[name] += count
        return self.outputs
