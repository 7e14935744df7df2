"""Where a step of the cluster-design and grid-design RNN kernels spends its time, on the card.

    python -m sample_factory_tpu_torch.ops.rnn_seq_phases [--resident]

Builds `csrc/rnn_seq.cu` with -DRNN_SEQ_PHASES, which makes thread 0 of every block add
the SM cycles (clock64) of each phase of each step, at the plans for this card's spec. Cluster design: the product h @ wh,
the gate math (with the wait for the step's x_proj), the copy of the new carry to the
other blocks plus the issue of the next step's prefetch, and the cluster barrier. Grid
design, forward and backward (`bwd_plan`'s grid design at the float32 H=512 learner sites): the h (dg) loads and
the product, the K splits' sums and the cells, the issue of the next step's prefetch, and the grid barrier. Runs each
kernel at the main-path shapes, at the
NetHack, AllegroHandLSTM and Doom learners' and at the multichip configuration's gathered GRU,
and prints one JSON line per case: the mean
cycles per block and step of each phase, the kernel's time over back-to-back launches
(CUDA events), the plan, and the clusters (blocks an SM) of that plan the card runs at
once. The clock calls cost a few cycles a phase; the kernel times of `chip_smoke.py` come
from the plain build. The grid backward is also timed built without its dg loads, without its
product and without both (BWD_ABLATIONS), in turns with the plain build. The cluster backward
(`bwd_plan`'s cluster design, at the `main`, `selfplay` and `lstm` learners, BWD_CLUSTER_CASES): the
product with its pushes into the peers' receive slots, the wait for the step's inputs and the cells,
the issue of the next step's copies, and the cluster barrier, and apart, thread 0's cycles in its
remote stores (inside the product phase). The resident design, forward and backward on its own plans (RESIDENT_CASES:
DMLab's instruction encoder in a rollout slot and over a learner minibatch; with --resident, these cases alone): the
product, the cells, the loads of the next step's inputs (into registers), and the block barrier; and `lstm_seq_in`'s kernels
there: the forward with the input product folded in (its "loads" phase: the step's input part and the next step's resets)
and the backward on the buffers that forward saved (no cell-state pass). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
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
PHASES = {"cluster": ["product", "gates", "push_and_prefetch", "barrier"], "grid": ["product", "cells", "prefetch", "barrier"],
          "cluster_bwd": ["product_and_push", "cells", "prefetch", "barrier"], "resident": ["product", "cells", "loads", "barrier"]}
# the resident design, forward and backward, on its own plan: DMLab's instruction encoder in a rollout slot and over a
# learner minibatch, and at twice the minibatch's rows in bf16
RESIDENT_CASES = [("lstm", 16, 64, 64, "float32"), ("lstm", 16, 1024, 64, "float32"), ("lstm", 16, 2048, 64, "bfloat16")]
# the cluster backward at the learners of `main` (GRU-256 bf16), `selfplay` (GRU-512 bf16, clusters of 16) and `lstm`
# (LSTM-256 float32): (kind, T, B, H, dtype)
BWD_CLUSTER_CASES = [("gru", 32, 512, 256, "bfloat16"), ("gru", 32, 512, 512, "bfloat16"), ("lstm", 32, 128, 256, "float32")]
# the grid design of the backward at the float32 H=512 learner sites: (kind, T, B, H); its phases are the grid forward's
# (the dg loads and the product, the splits' sums and the cells, the next step's prefetch and input loads, the barrier)
BWD_CASES = [("gru", 32, 64, 512), ("gru", 32, 32, 512), ("gru", 16, 4, 512), ("lstm", 32, 24, 512), ("lstm", 16, 2048, 512)]
# the grid backward built without its dg loads, without its product, and without both (wrong results, times only),
# timed in turns with the plain build: how much of a step each takes, and whether the two overlap
BWD_ABLATIONS = {"plain": (), "no_loads": ("-DRNN_SEQ_BWD_ABLATE_LOADS",), "no_product": ("-DRNN_SEQ_BWD_ABLATE_PRODUCT",),
                 "neither": ("-DRNN_SEQ_BWD_ABLATE_LOADS", "-DRNN_SEQ_BWD_ABLATE_PRODUCT")}
BWD_ENTRIES = ("gru_seq_grid_backward", "lstm_seq_grid_backward")


def _inputs(kind, T, B, H, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    G, dt = cuda_rnn._gates(kind), getattr(torch, dtype)
    x = torch.randn(T, B, G * H, generator=g, device="cuda").to(dt)
    s0 = torch.randn(B, H if kind == "gru" else 2 * H, generator=g, device="cuda")
    resets = (torch.rand(T, B, generator=g, device="cuda") < 0.1).float()
    wh = (torch.randn(H, G * H, generator=g, device="cuda") / H**0.5).to(dt)
    bh = (torch.randn(G * H, generator=g, device="cuda") * 0.1).to(dt)
    return [x, s0, resets, wh] + ([bh] if kind == "gru" else [])


@contextlib.contextmanager
def _library(lib):
    """`cuda_rnn`'s launches go to `lib` (another build of the source) inside the block."""
    load = cuda_rnn.load_library
    cuda_rnn.load_library = lambda defines=(): lib
    try:
        yield
    finally:
        cuda_rnn.load_library = load


def _bwd_inputs(kind, T, B, H, dtype="float32"):
    """The backward recurrence's inputs (the saved tensors and projections a prologue makes), from random data."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x, s0, resets, wh, *bh = _inputs(kind, T, B, H, dtype)
    d_out = torch.randn(T, B, H, generator=g, device="cuda")
    d_state = torch.randn(*s0.shape, generator=g, device="cuda")
    with torch.no_grad():
        outs, _ = (cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm)(x, s0, resets, wh, *bh)
        h_prev = cuda_rnn._carries_in(s0, resets, outs)
        h_in = h_prev.to(x.dtype)
    if kind == "gru":
        return d_out, d_state, resets, x, h_in @ wh + bh[0], h_prev, wh
    return d_out, d_state, resets, x + h_in @ wh, s0, wh


IN_WIDTH = 20  # DMLab's instruction embedding, the input width of lstm_seq_in's kernel at the resident cases


def _in_inputs(T, B, H, dtype, I=IN_WIDTH):
    """lstm_seq_in's inputs from random data: x [T,B,I] (a transposed view of [B,T,I], as the instruction encoder gives it), wi,
    bi, hc0, resets, wh."""
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    x = torch.randn(B, T, I, generator=g, device="cuda").to(dt).transpose(0, 1)
    wi = (torch.randn(I, 4 * H, generator=g, device="cuda") / I**0.5).to(dt)
    bi = (torch.randn(4 * H, generator=g, device="cuda") * 0.1).to(dt)
    hc0 = torch.randn(B, 2 * H, generator=g, device="cuda")
    resets = (torch.rand(T, B, generator=g, device="cuda") < 0.1).float()
    wh = (torch.randn(H, 4 * H, generator=g, device="cuda") / H**0.5).to(dt)
    return x, wi, bi, hc0, resets, wh


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--resident", action="store_true", help="the resident design's cases alone")
    opts = parser.parse_args()
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
    for kind, T, B, H, dtype in [] if opts.resident else CASES:
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, spec)
        launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
        args = _inputs(kind, T, B, H, dtype)
        with torch.no_grad():
            ms = _batched_ms(lambda: launch(*args))
            lib.rnn_seq_phases_reset()
            launch(*args)
            torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 5)()
        lib.rnn_seq_phases_read(ctypes.addressof(cycles))
        per_step = {name: cycles[i] / (plan.grid * T) for i, name in enumerate(PHASES[plan.design])}
        if plan.design == "cluster":
            at_once = {"clusters": plan.grid // plan.cluster, "max_active_clusters": cuda_rnn.max_active_clusters(kind, dtype, plan)}
        elif plan.design == "grid":
            at_once = {"blocks": plan.grid, "blocks_per_sm": cuda_rnn.grid_blocks_per_sm(kind, plan)}
        else:
            at_once = {"blocks": plan.grid, "threads": plan.threads}
        print(json.dumps({
            "kernel": cuda_rnn._kernel_name(kind, plan), "shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(plan),
            **at_once, "card_spec": dataclasses.asdict(spec), "ms_back_to_back": ms, "cycles_per_step": per_step, "cycles_per_step_total": sum(per_step.values()),
            "card": card,
        }), flush=True)
    ablations = {} if opts.resident else {name: cuda_rnn.bind(cuda_rnn.build(defines), BWD_ENTRIES) for name, defines in BWD_ABLATIONS.items()}
    for kind, T, B, H in [] if opts.resident else BWD_CASES:
        plan = cuda_rnn.bwd_plan(kind, B, H, "float32", spec)
        rec = _bwd_inputs(kind, T, B, H)
        launch = cuda_rnn._launch_gru_bwd if kind == "gru" else cuda_rnn._launch_lstm_bwd
        with torch.no_grad():
            ms = _batched_ms(lambda: launch(*rec), launches=5)
            lib.rnn_seq_phases_reset()
            launch(*rec)
            torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 5)()
        lib.rnn_seq_phases_read(ctypes.addressof(cycles))
        per_step = {name: cycles[i] / (plan.grid * T) for i, name in enumerate(PHASES["grid"])}
        ablated = {}  # the plain build and the ablation builds in turns
        for turn in (*ablations, *reversed(ablations)):
            with _library(ablations[turn]), torch.no_grad():
                ablated.setdefault(turn, []).append(_batched_ms(lambda: launch(*rec), launches=5))
        print(json.dumps({
            "kernel": f"{kind}_seq_grid_bwd", "shape": [T, B, H], "dtype": "float32", "plan": dataclasses.asdict(plan),
            "blocks": plan.grid, "blocks_per_sm": cuda_rnn.grid_bwd_blocks_per_sm(kind, plan), "card_spec": dataclasses.asdict(spec),
            "ms_back_to_back": ms, "cycles_per_step": per_step, "cycles_per_step_total": sum(per_step.values()),
            "ablation_ms": {name: sorted(v)[len(v) // 2] for name, v in ablated.items()}, "card": card,
        }), flush=True)
    for kind, T, B, H, dtype in [] if opts.resident else BWD_CLUSTER_CASES:
        plan = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
        rec = _bwd_inputs(kind, T, B, H, dtype)
        launch = cuda_rnn._launch_gru_bwd if kind == "gru" else cuda_rnn._launch_lstm_bwd
        with torch.no_grad():
            ms = _batched_ms(lambda: launch(*rec), launches=10)
            lib.rnn_seq_phases_reset()
            launch(*rec)
            torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 5)()
        lib.rnn_seq_phases_read(ctypes.addressof(cycles))
        per_step = {name: cycles[i] / (plan.grid * T) for i, name in enumerate(PHASES["cluster_bwd"])}
        print(json.dumps({
            "kernel": cuda_rnn._bwd_kernel_name(kind, plan), "shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(plan),
            "clusters": plan.grid // plan.cluster, "max_active_clusters": cuda_rnn.max_active_bwd_clusters(kind, dtype, plan),
            "card_spec": dataclasses.asdict(spec), "ms_back_to_back": ms, "cycles_per_step": per_step,
            "cycles_per_step_total": sum(per_step.values()), "push_cycles_per_step_thread0": cycles[4] / (plan.grid * T), "card": card,
        }), flush=True)
    for kind, T, B, H, dtype in RESIDENT_CASES:
        args = _inputs(kind, T, B, H, dtype)
        rec = _bwd_inputs(kind, T, B, H, dtype)
        in_args = _in_inputs(T, B, H, dtype)
        with torch.no_grad():
            _, _, proj, cells, _ = cuda_rnn._launch_lstm_in(*in_args, save=True)
        in_rec = (*rec[:3], proj, in_args[3], in_args[5], cells)
        for name, plan, launch in (("lstm_seq_resident", cuda_rnn.resident_plan(kind, B, H, dtype, spec), cuda_rnn._launch_lstm),
                                   ("lstm_seq_resident_bwd", cuda_rnn.resident_plan(kind, B, H, dtype, spec, backward=True),
                                    cuda_rnn._launch_lstm_bwd),
                                   ("lstm_seq_resident_in", cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, dtype, spec), cuda_rnn._launch_lstm_in),
                                   ("lstm_seq_resident_in_bwd", cuda_rnn.resident_plan(kind, B, H, dtype, spec, backward=True),
                                    cuda_rnn._launch_lstm_in_bwd)):
            inputs = {"lstm_seq_resident": args, "lstm_seq_resident_bwd": rec, "lstm_seq_resident_in": in_args,
                      "lstm_seq_resident_in_bwd": in_rec}[name]
            with torch.no_grad():
                ms = _batched_ms(lambda: launch(*inputs, plan=plan), launches=10)
                lib.rnn_seq_phases_reset()
                launch(*inputs, plan=plan)
                torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 5)()
            lib.rnn_seq_phases_read(ctypes.addressof(cycles))
            per_step = {phase: cycles[i] / (plan.grid * T) for i, phase in enumerate(PHASES["resident"])}
            print(json.dumps({
                "kernel": name, "shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(plan), "blocks": plan.grid,
                "threads": plan.threads, "card_spec": dataclasses.asdict(spec), "ms_back_to_back": ms, "cycles_per_step": per_step,
                "cycles_per_step_total": sum(per_step.values()),
                "stat": "cycles of thread 0 of each block, its mean over blocks and steps (the backward's cell-state pass before "
                        "its loop, and the load of wh, are in no phase)", "card": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
