"""Where a step of the cluster-design and grid-design RNN kernels spends its time, on the card.

    python -m sample_factory_tpu_torch.ops.rnn_seq_phases

Builds `csrc/rnn_seq.cu` with -DRNN_SEQ_PHASES, which makes thread 0 of every block add
the SM cycles (clock64) of each phase of each step, at the plans for this card's spec. Cluster design: the product h @ wh,
the gate math (with the wait for the step's x_proj), the copy of the new carry to the
other blocks plus the issue of the next step's prefetch, and the cluster barrier. Grid
design: the h loads and the product, the K splits' sums and the cells, the issue of the
next step's prefetch, and the grid barrier. Runs each kernel at the main-path shapes, at the
NetHack, AllegroHandLSTM and Doom learners' and at the multichip configuration's gathered GRU,
and prints one JSON line per case: the mean
cycles per block and step of each phase, the kernel's time over back-to-back launches
(CUDA events), the plan, and the clusters (blocks an SM) of that plan the card runs at
once. The clock calls cost a few cycles a phase; the kernel times of `chip_smoke.py` come
from the plain build. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess

import torch

from sample_factory_tpu_torch.ops import cuda_rnn

CASES = [
    ("gru", 32, 512, 256, "bfloat16"),  # the main path's GRU
    ("lstm", 32, 128, 256, "float32"),  # the lstm path
    ("gru", 32, 512, 256, "float32"),
    ("lstm", 32, 512, 256, "bfloat16"),
    ("lstm", 32, 24, 512, "float32"),  # the NetHack learner (grid design)
    ("lstm", 16, 2048, 512, "float32"),  # the AllegroHandLSTM learner (grid design)
    ("gru", 32, 64, 512, "float32"),  # the Doom learner (grid design)
    ("gru", 16, 4, 512, "float32"),  # the multichip configuration's gathered GRU (grid design)
]
PHASES = {"cluster": ["product", "gates", "push_and_prefetch", "barrier"], "grid": ["product", "cells", "prefetch", "barrier"]}


def _inputs(kind, T, B, H, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    G, dt = cuda_rnn._gates(kind), getattr(torch, dtype)
    x = torch.randn(T, B, G * H, generator=g, device="cuda").to(dt)
    s0 = torch.randn(B, H if kind == "gru" else 2 * H, generator=g, device="cuda")
    resets = (torch.rand(T, B, generator=g, device="cuda") < 0.1).float()
    wh = (torch.randn(H, G * H, generator=g, device="cuda") / H**0.5).to(dt)
    bh = (torch.randn(G * H, generator=g, device="cuda") * 0.1).to(dt)
    return [x, s0, resets, wh] + ([bh] if kind == "gru" else [])


def _batched_ms(fn, launches=20, batches=5):
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)  # the host enqueues the launches while the card spins
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rnn_seq_phases needs a CUDA card")
    lib = cuda_rnn.load_library(("-DRNN_SEQ_PHASES",))
    lib.rnn_seq_phases_read.argtypes = [ctypes.c_void_p]
    lib.rnn_seq_phases_reset.argtypes = []
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    spec = cuda_rnn.card_spec(torch.device("cuda"))
    for kind, T, B, H, dtype in CASES:
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, spec)
        launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
        args = _inputs(kind, T, B, H, dtype)
        with torch.no_grad():
            ms = _batched_ms(lambda: launch(*args))
            lib.rnn_seq_phases_reset()
            launch(*args)
            torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 4)()
        lib.rnn_seq_phases_read(ctypes.addressof(cycles))
        per_step = {name: cycles[i] / (plan.grid * T) for i, name in enumerate(PHASES[plan.design])}
        at_once = ({"clusters": plan.grid // plan.cluster, "max_active_clusters": cuda_rnn.max_active_clusters(kind, dtype, plan)}
                   if plan.design == "cluster" else {"blocks": plan.grid, "blocks_per_sm": cuda_rnn.grid_blocks_per_sm(kind, plan)})
        print(json.dumps({
            "kernel": cuda_rnn._kernel_name(kind, plan), "shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(plan),
            **at_once, "card_spec": dataclasses.asdict(spec), "ms_back_to_back": ms, "cycles_per_step": per_step, "cycles_per_step_total": sum(per_step.values()),
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
