"""The card's name and power limit, and the device time of a stretch of work under torch.profiler.

Shared by `chip_smoke.py` and `bench_gpu.py`, so that the two read the card and its busy time
alike. torch is imported at the call, not with the module: `chip_smoke.py` imports this module
before the isaacgym stand-in, which refuses a process that has imported torch.
"""

from __future__ import annotations

import subprocess
import time

RNN_KERNELS = ("seq_cluster_kernel", "grid_kernel", "rows_kernel", "seq_bwd_kernel", "seq_bwd_grid_kernel", "seq_bwd_cluster_kernel",
               "resident_kernel", "resident_bwd_kernel", "resident_in_kernel")  # the symbols of csrc/rnn_seq.cu's kernels


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def power_limit_w(line: str) -> float:
    """The power limit in watts of a `card_line()`."""
    return float(line.rsplit(",", 1)[1].strip().split()[0])


def device_activities(prof):
    """(device busy us, RNN kernels' us, the device activities, their us by name) of a finished
    torch.profiler run that recorded the device's activities alone (kernels, copies, sets): one
    stream, so their times add up."""
    import torch

    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    rnn_us = sum(e.time_range.elapsed_us() for e in on_device if any(k in e.name for k in RNN_KERNELS))
    return sum(by_name.values()), rnn_us, on_device, by_name


def profiled_device_time(fn):
    """Run fn under torch.profiler, recording CUDA activity only: (wall us, device busy us,
    RNN kernels' us, the device activities, their us by name)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    return (wall_us, *device_activities(prof))
