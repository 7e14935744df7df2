"""Host timing of the port: `Timing`, the runners' additive sums that the runner's last log line reports, and
`tracer()`, the process-wide tracer of the training loop.

The tracer records spans (name, parent span, iteration, start and end) and counters kept per iteration, and only
while a torch.profiler session records: `Runner.run` asks at the start of every iteration (`begin_iteration`), so
tracing is on for an iteration exactly when a profiler records at its start. Every span then also opens
`torch.profiler.record_function(name)`, so that the profiler's trace carries it, and is passed, when it ends, to
the runner's observers (`AlgoObserver.span(name, start_s, end_s)`, `time.perf_counter` seconds). A span's record
holds its start and end in ns on the clock torch.profiler stamps its events with (the wall clock,
`time.time_ns`), converted from `perf_counter_ns` through one pair of readings taken when tracing turned on. The
records stay in memory until tracing next turns on, or a run starts (`clear`), so a reader finds the last stretch
recorded: `spans`, `counters` (one dict an iteration) and `iterations`.

Off, `span()` returns one shared null context and reads no clock; `host_read` only converts; `count` does nothing.
`host_read(site, tensor)` is the one way the training loop reads the device: on, it records its wait as the span
`sync.<site>` and counts one `host_syncs` in the iteration.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch


class Timing:
    """Host-clock seconds added up by key: `with timing.add_time("save"): ...`; `flat_str()` reports them."""

    def __init__(self):
        self._values: Dict[str, float] = {}

    @contextmanager
    def add_time(self, key: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self._values[key] = self._values.get(key, 0.0) + time.perf_counter() - start

    def flat_str(self) -> str:
        return ", ".join(f"{k}: {v:.4f}" for k, v in self._values.items())


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the name of the span that was open when it began
    iteration: int  # index among the iterations recorded
    start_ns: int  # on torch.profiler's clock
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_OFF = nullcontext()


def _to_host(tensor: torch.Tensor):
    """A 0-d tensor's Python number, else a host copy of the tensor."""
    return tensor.item() if tensor.dim() == 0 else tensor.cpu()


def _clock_anchor() -> int:
    """time_ns minus perf_counter_ns, the wall-clock reading taken between two perf_counter readings."""
    before = time.perf_counter_ns()
    wall = time.time_ns()
    return wall - (before + time.perf_counter_ns()) // 2


class _OpenSpan:
    __slots__ = ("tracer", "name", "parent", "start", "annotation")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        stack = self.tracer._stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.perf_counter_ns()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end = time.perf_counter_ns()
        self.tracer._stack.pop()
        self.tracer._record(self.name, self.parent, self.start, end)
        return False


class Tracer:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.counters: List[Dict[str, int]] = []
        self._stack: List[str] = []
        self._observers: tuple = ()
        self._anchor_ns = 0

    @property
    def iterations(self) -> int:
        """The iterations recorded in the last traced stretch."""
        return len(self.counters)

    def clear(self) -> None:
        self.spans, self.counters = [], []

    def begin_iteration(self, observers=()) -> None:
        """At the start of each training iteration: tracing is on for it while a torch.profiler session records.
        Turning on drops the last stretch's records and takes the clock's anchor."""
        on = torch.autograd.profiler._is_profiler_enabled
        if on and not self.on:
            self.clear()
            self._anchor_ns = _clock_anchor()
        self.on = on
        if on:
            self._observers = tuple(observers)
            self.counters.append({})

    def end(self) -> None:
        """After the training loop: tracing off until the next iteration that begins under a profiler."""
        self.on = False
        self._observers = ()

    def span(self, name: str):
        return _OpenSpan(self, name) if self.on else _OFF

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            counters = self.counters[-1]
            counters[name] = counters.get(name, 0) + n

    def host_read(self, site: str, tensor: torch.Tensor):
        """The host value of `tensor` (a Python number for a 0-d tensor, else a host copy): one host sync, recorded
        as the span `sync.<site>` while tracing."""
        if not self.on:
            return _to_host(tensor)
        with _OpenSpan(self, "sync." + site):
            value = _to_host(tensor)
        self.count("host_syncs")
        return value

    def _record(self, name: str, parent: Optional[str], start: int, end: int) -> None:
        anchor = self._anchor_ns
        self.spans.append(Span(name, parent, len(self.counters) - 1, start + anchor, end + anchor))
        for obs in self._observers:
            obs.span(name, start / 1e9, end / 1e9)


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER
