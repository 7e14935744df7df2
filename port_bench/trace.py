"""Reading a torch.profiler run that recorded the device's activities alone (kernels, copies, sets).

Busy time is the union of the activities' intervals, so that work on two streams at once is counted once. The RNN
kernels are the activities whose names match a pattern of `metrics/rnn_kernels.d/*.txt` (one regular expression a
line, `#` starts a comment); a PR that adds a kernel adds a file there. Idle gaps are named by the benchmark's host
span that was open when the gap began (times relative to the profiler's start on both sides).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

PATTERN_DIR = Path(__file__).resolve().parent / "metrics" / "rnn_kernels.d"
TOP = 10


def rnn_patterns(directory: Path = PATTERN_DIR) -> List[re.Pattern]:
    out = []
    for path in sorted(directory.glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(re.compile(line))
    return out


def device_activities(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device activity, start relative to the profiler's start."""
    import torch

    return [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_intervals(acts: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, start, end in sorted(acts, key=lambda a: a[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(acts, wall_us: float, spans: List[Tuple[str, float, float]], patterns=None) -> Dict:
    """acts: device activities; wall_us: the profiled window; spans: the host spans (name, start us, end us) in the
    profiler's time. Returns busy and RNN-kernel us, and the breakdown's two lists."""
    patterns = rnn_patterns() if patterns is None else patterns
    merged = busy_intervals(acts)
    busy = sum(b - a for a, b in merged)
    rnn = sum(e - s for name, s, e in acts if any(p.search(name) for p in patterns))
    by_name: Dict[str, float] = {}
    for name, s, e in acts:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(merged, merged[1:])]
    if merged:
        gaps = [(0.0, merged[0][0])] + gaps + [(merged[-1][1], wall_us)]

    def host_doing(t):
        open_spans = [s for s in spans if s[1] <= t < s[2]]
        return min(open_spans, key=lambda s: s[2] - s[1])[0] if open_spans else "between spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_us": busy,
        "rnn_us": rnn,
        "device_ops": [[name, us / 1e6] for name, us in top_ops],
        "idle_gaps": [[host_doing(a), (b - a) / 1e6] for a, b in longest if b > a],
    }
