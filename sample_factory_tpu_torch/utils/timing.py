"""Hierarchical context-manager profiler.

Copy of `sample_factory_tpu/utils/timing.py` (reference
`sample_factory/utils/timing.py:74-161`: timeit/add_time/time_avg modes and
nested tree reports). Host clock only: time device work after a
`torch.cuda.synchronize()`, or with CUDA events.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional


class AvgTime:
    def __init__(self, num_values_to_avg: int):
        self.values: Deque[float] = deque(maxlen=num_values_to_avg)

    def tofloat(self) -> float:
        return sum(self.values) / max(1, len(self.values))

    def __str__(self) -> str:
        return f"{self.tofloat():.4f}"


class _TimingContext:
    def __init__(self, timing: "Timing", key: str, additive: bool = False, average: Optional[int] = None):
        self._timing = timing
        self._key = key
        self._additive = additive
        self._average = average
        self._time_enter: float = 0.0

    def initial_value(self):
        if self._average is not None:
            return AvgTime(num_values_to_avg=self._average)
        return 0.0

    def __enter__(self):
        self._time_enter = time.perf_counter()
        self._timing._push(self._key, self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        elapsed = time.perf_counter() - self._time_enter
        self._timing._pop(self._key, elapsed, self._additive, self._average)
        return False


class Timing:
    """Usage:
        timing = Timing("learner")
        with timing.timeit("train"): ...         # last value
        with timing.add_time("forward"): ...     # additive across calls
        with timing.time_avg("one_step"): ...    # moving average
    Keys nested inside other contexts form a tree in the report.
    """

    def __init__(self, name: str = "Profile"):
        self.name = name
        self._values: Dict[str, object] = {}
        self._stack: list = []
        self._children: Dict[Optional[str], set] = {None: set()}

    # context-manager factories
    def timeit(self, key: str) -> _TimingContext:
        return _TimingContext(self, key)

    def add_time(self, key: str) -> _TimingContext:
        return _TimingContext(self, key, additive=True)

    def time_avg(self, key: str, average: int = 10) -> _TimingContext:
        return _TimingContext(self, key, average=average)

    # internal bookkeeping
    def _push(self, key: str, ctx: _TimingContext) -> None:
        parent = self._stack[-1] if self._stack else None
        self._children.setdefault(parent, set()).add(key)
        self._children.setdefault(key, set())
        self._stack.append(key)
        if key not in self._values:
            self._values[key] = ctx.initial_value()

    def _pop(self, key: str, elapsed: float, additive: bool, average: Optional[int]) -> None:
        assert self._stack and self._stack[-1] == key
        self._stack.pop()
        if average is not None:
            self._values[key].values.append(elapsed)
        elif additive:
            self._values[key] = float(self._values[key]) + elapsed
        else:
            self._values[key] = elapsed

    def __getattr__(self, item):
        values = self.__dict__.get("_values", {})
        if item in values:
            v = values[item]
            return v.tofloat() if isinstance(v, AvgTime) else v
        raise AttributeError(item)

    def todict(self) -> Dict[str, float]:
        return {k: (v.tofloat() if isinstance(v, AvgTime) else float(v)) for k, v in self._values.items()}

    def flat_str(self) -> str:
        return ", ".join(f"{k}: {v:.4f}" for k, v in self.todict().items())

    def _node_str(self, key: str, depth: int) -> list:
        v = self._values[key]
        s = v.tofloat() if isinstance(v, AvgTime) else float(v)
        lines = ["  " * depth + f"{key}: {s:.4f}"]
        for child in sorted(self._children.get(key, ())):
            lines.extend(self._node_str(child, depth + 1))
        return lines

    def __str__(self) -> str:
        lines = [f"Timing tree for {self.name}:"]
        for root in sorted(self._children.get(None, ())):
            lines.extend(self._node_str(root, 1))
        return "\n".join(lines)
