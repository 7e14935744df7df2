#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sample_factory_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build     compile the hand-written kernels (csrc/rnn_seq.cu, sm_90a) from the checkout
  parity    each kernel against its plain PyTorch version on the card, forward and
            gradient, float32 and bfloat16, at the main-path shape, the default width
            and odd shapes; both designs of the launch plan (cluster and rows) run
  timing    each kernel, its plain version and the bound at the main-path shapes; each
            kernel in both dtypes at (32, 512, 256), warm and with L2 flushed, beside the
            first design (rows) at the same shapes; torch.nn.GRU (cuDNN) as a yardstick
  main      sync PPO on grid_battle at full width (IMPALA conv, GRU-256, bf16,
            1024 envs, rollout 32) for 3 iterations through `run_rl`'s runner
  breakdown one more main-path iteration: rollout and learner times, then one under
            torch.profiler for the device's busy share and its top kernels
  lstm      the --rnn_type=lstm path (float32, 128 envs, 1 iteration), then the
            trained model on the card against the same model on the CPU
Then a `kernels` line, the card's name and power limit, and the result line.
Needs one CUDA card; exits non-zero on any failure. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside the tensor cores
MAIN_GRU = (32, 512, 256, "bfloat16")  # T, segments per minibatch (16384 / 32), H, dtype
MAIN_LSTM = (32, 128, 256, "float32")  # the lstm phase: 128 envs x 32 steps in one minibatch
# (32, 512, 512): the default rnn_size; (4, 16, 1024): no cluster slice fits, the row design
PARITY_SHAPES = [(32, 512, 256), (7, 24, 128), (1, 8, 128), (5, 3, 64), (32, 512, 512), (4, 16, 1024)]
# bf16: kernel and plain version round every gate op to bf16 alike, but sum h @ wh in
# another order, so a product can land one bf16 ulp apart; that flip (2^-8 relative,
# up to 2^-6 absolute at the LSTM cell's magnitudes) feeds forward through the recurrence.
BF16_TOL = 0.0625
REPS = 25
SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1980 MHz
L2_FLUSH_BYTES = 100 * 2**20  # written between reps of a cold timing: twice the H100's 50 MB L2
SOURCE = "sample_factory_tpu_torch/csrc/rnn_seq.cu"
REPLACES = {
    "gru_seq": "sample_factory_tpu/ops/pallas_gru.py:148",
    "lstm_seq": "sample_factory_tpu/ops/pallas_gru.py:271",
}


def emit(record):
    print(json.dumps(record), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fwd_tol(dtype, T):
    return 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_TOL


def make_inputs(torch, kind, T, B, H, dtype, seed=0, device="cuda"):
    import numpy as np

    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.normal(size=(T, B, G * H)).astype(np.float32), device=device).to(dt)
    s0 = torch.tensor(rng.normal(size=(B, H * (1 if kind == "gru" else 2))).astype(np.float32), device=device)
    resets = torch.tensor((rng.random((T, B)) < 0.1).astype(np.float32), device=device)
    wh = torch.tensor((rng.normal(size=(H, G * H)) / math.sqrt(H)).astype(np.float32), device=device).to(dt)
    args = [x, s0, resets, wh]
    if kind == "gru":
        args.append(torch.tensor((rng.normal(size=(G * H,)) * 0.1).astype(np.float32), device=device).to(dt))
    return args


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def phase_parity(torch, cuda_rnn):
    fns = {"gru": (cuda_rnn.gru_seq, cuda_rnn.gru_seq_reference), "lstm": (cuda_rnn.lstm_seq, cuda_rnn.lstm_seq_reference)}
    main_err = {}
    for kind, (kernel_fn, plain_fn) in fns.items():
        for dtype in ("float32", "bfloat16"):
            for T, B, H in PARITY_SHAPES:
                args = make_inputs(torch, kind, T, B, H, dtype, seed=T + B + H)
                args = [a.requires_grad_(i != 2) for i, a in enumerate(args)]
                plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
                name = f"{kind}_seq" if plan.design == "cluster" else f"{kind}_seq_rows"
                before = cuda_rnn.launch_counts()[name]
                out, state = kernel_fn(*args)
                torch.cuda.synchronize()
                check(cuda_rnn.launch_counts()[name] == before + 1, f"{kind} {(T, B, H)}: {name} was not launched")
                ref_out, ref_state = plain_fn(*args)
                wrt = [a for i, a in enumerate(args) if i != 2]
                grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
                ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
                torch.cuda.synchronize()
                fwd = max(float((out - ref_out).detach().abs().max()), float((state - ref_state).detach().abs().max()))
                grad = max(rel_err(g, r) for g, r in zip(grads, ref_grads))
                tol = fwd_tol(dtype, T)
                # gradients: the backward reruns the plain version, so they differ only
                # through the forward outputs that seed it; scaled by the largest gradient
                grad_tol = 1e-3 if dtype == "float32" else 4 * BF16_TOL
                emit({"phase": "parity", "kernel": name, "design": dataclasses.asdict(plan), "dtype": dtype, "shape": [T, B, H],
                      "fwd_max_abs_err": fwd, "fwd_tol": tol, "grad_rel_err": grad, "grad_tol": grad_tol})
                check(fwd <= tol, f"{kind} {dtype} {(T, B, H)}: forward error {fwd} > {tol}")
                check(grad <= grad_tol, f"{kind} {dtype} {(T, B, H)}: gradient error {grad} > {grad_tol}")
        # the error reported for the kernel: at the shape and dtype of its main path
        T, B, H, dtype = MAIN_GRU if kind == "gru" else MAIN_LSTM
        args = make_inputs(torch, kind, T, B, H, dtype, seed=1)
        with torch.no_grad():
            out, state = kernel_fn(*args)
            torch.cuda.synchronize()
            ref_out, ref_state = plain_fn(*args)
        main_err[f"{kind}_seq"] = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
        check(main_err[f"{kind}_seq"] <= fwd_tol(dtype, T), f"{kind} at its main-path shape disagrees")
    return main_err


def time_ms(torch, fn, reps=REPS, flush=None):
    """Median of `reps` CUDA-event timings of fn after 3 warm-up calls; with `flush` (a tensor
    of L2_FLUSH_BYTES), the L2 cache is overwritten before each timed call. Before the start
    event the card spins for ~0.5 ms, so that the host has enqueued fn's kernels by the time
    the event is reached: the interval is the device's time, not the host's launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(kind, T, B, H, dtype):
    """Least time for the function on an H100: each input read once, each output written
    once, against the products' operations at the peak rate of their type."""
    G = 3 if kind == "gru" else 4
    item = 2 if dtype == "bfloat16" else 4
    state = H if kind == "gru" else 2 * H
    nbytes = T * B * G * H * item + B * state * 4 + T * B * 4 + H * G * H * item + T * B * H * 4 + B * state * 4
    if kind == "gru":
        nbytes += G * H * item
    flops = 2 * T * B * H * G * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_timing(torch, cuda_rnn, card):
    launches = {"gru": cuda_rnn._launch_gru, "lstm": cuda_rnn._launch_lstm}
    plains = {"gru": cuda_rnn.gru_seq_reference, "lstm": cuda_rnn.lstm_seq_reference}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    out = {}
    with torch.no_grad():
        # the main-path rows, comparable with the first design's numbers
        for kind, (T, B, H, dtype) in (("gru", MAIN_GRU), ("lstm", MAIN_LSTM)):
            args = make_inputs(torch, kind, T, B, H, dtype, seed=2)
            plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
            rows = cuda_rnn.row_plan(kind, B, H)
            ms = time_ms(torch, lambda: launches[kind](*args))
            rows_ms = time_ms(torch, lambda: launches[kind](*args, plan=rows))
            plain_ms = time_ms(torch, lambda: plains[kind](*args))
            ms_l2_cold = time_ms(torch, lambda: launches[kind](*args), flush=flush)
            rows_ms_l2_cold = time_ms(torch, lambda: launches[kind](*args, plan=rows), flush=flush)
            bound_ms, bound_by, nbytes, flops = bound(kind, T, B, H, dtype)
            # for the kernels line: the plan, and the time of the kernel's first design (the row design)
            out[f"{kind}_seq"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                                  "design": dataclasses.asdict(plan), "pr1_ms": rows_ms}
            emit({"phase": "timing", "kernel": f"{kind}_seq", "shape": [T, B, H], "dtype": dtype, "ms": ms,
                  "rows_ms": rows_ms, "ms_l2_cold": ms_l2_cold, "rows_ms_l2_cold": rows_ms_l2_cold, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                  "design": dataclasses.asdict(plan), "reps": REPS,
                  "stat": "median of CUDA-event times; ms: L2 not flushed, l2_cold: 100 MB written before each; "
                          "rows: the first design (row design) at the same shape", "card": card})
        # each kernel in both dtypes at the GRU's main shape, warm and L2-cold, beside the row design
        T, B, H = MAIN_GRU[:3]
        for kind in ("gru", "lstm"):
            for dtype in ("bfloat16", "float32"):
                args = make_inputs(torch, kind, T, B, H, dtype, seed=3)
                rows = cuda_rnn.row_plan(kind, B, H)
                row = {"phase": "timing", "kernel": f"{kind}_seq", "shape": [T, B, H], "dtype": dtype,
                       "design": dataclasses.asdict(cuda_rnn.launch_plan(kind, T, B, H, dtype))}
                for label, flush_with in (("warm", None), ("l2_cold", flush)):
                    row[f"ms_{label}"] = time_ms(torch, lambda: launches[kind](*args), flush=flush_with)
                    row[f"rows_ms_{label}"] = time_ms(torch, lambda: launches[kind](*args, plan=rows), flush=flush_with)
                row["bound_ms"], row["bound_by"] = bound(kind, T, B, H, dtype)[:2]
                emit({**row, "reps": REPS, "stat": "median of CUDA-event times; l2_cold: 100 MB written before each",
                      "card": card})
        # a yardstick of another function: cuDNN's GRU also computes the input product and has
        # no resets; the port never calls it
        gru = torch.nn.GRU(H, H).cuda().to(torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(T, B, H, device="cuda", dtype=torch.bfloat16)
        h0 = torch.zeros(1, B, H, device="cuda", dtype=torch.bfloat16)
        emit({"phase": "timing", "yardstick": "torch.nn.GRU (cuDNN), a different function: input product included, "
              "no resets", "shape": [T, B, H], "dtype": "bfloat16",
              "ms_warm": time_ms(torch, lambda: gru(x, h0)), "ms_l2_cold": time_ms(torch, lambda: gru(x, h0), flush=flush),
              "reps": REPS, "card": card})
    del flush
    return out


def train(torch, cuda_rnn, argv, train_dir):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.runner.runner import AlgoObserver
    from sample_factory_tpu_torch.train import make_rl_runner

    class IterationClock(AlgoObserver):
        """The host time at the end of each iteration, after a sync."""

        def __init__(self):
            self.times = []

        def on_training_iteration(self, runner, stats):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())

    register_synthetic_components()
    _, runner = make_rl_runner(parse_custom_args(argv + [f"--train_dir={train_dir}", "--device=gpu", "--seed=0"]))
    clock = IterationClock()
    runner.register_observer(clock)
    runner.init()
    torch.cuda.synchronize()
    cuda_rnn.reset_launch_counts()
    start = time.perf_counter()
    check(runner.run() == 0, "runner.run() failed")
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    stats = runner.host_stats()
    check(stats and all(math.isfinite(v) for v in stats.values()), f"non-finite training stats: {stats}")
    exp = os.path.join(train_dir, runner.cfg.experiment)
    check(os.path.isfile(os.path.join(exp, "config.json")), "config.json missing")
    check(os.path.isfile(os.path.join(exp, "done")), "done file missing")
    ckpts = [f for f in os.listdir(os.path.join(exp, "checkpoint_p0")) if f.startswith("checkpoint_")]
    check(len(ckpts) >= 1, "no checkpoint written")
    return runner, counts, stats, [start] + clock.times


COMMON = [
    "--env=grid_battle", "--async_rl=False", "--use_rnn=True", "--rnn_size=256",
    "--encoder_conv_architecture=convnet_impala", "--encoder_conv_mlp_layers", "256",
    "--rollout=32", "--recurrence=32", "--num_epochs=1", "--num_workers=1", "--normalize_input=True",
    "--save_every_sec=100000", "--save_best_every_sec=100000", "--experiment_summaries_interval=100000",
]


def phase_main(torch, cuda_rnn, card, tmp):
    iters, envs = 3, 1024
    argv = COMMON + ["--rnn_type=gru", "--compute_dtype=bfloat16", "--batch_size=16384", f"--num_envs={envs}",
                     f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_gru"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == 2 * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * iters}")
    check(counts["lstm_seq"] == 0, "LSTM kernel launched on the GRU path")
    steady = per_iter[1:]
    emit({"phase": "main", "env": "grid_battle", "envs": envs, "rollout": 32, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_steady": envs * 32 * len(steady) / sum(steady),
          "env_steps_per_s_all": runner.env_steps / sum(per_iter),
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return runner, counts


def phase_breakdown(torch, runner, card):
    """Where an iteration's time goes: rollout vs learner (host clock, synced), then
    the device's busy time under torch.profiler (sum of kernel times / wall time)."""
    ts = runner.train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss, traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state, ts.train_step, runner.policy_id)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner._train_fn(ts, traj, runner.train_generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    runner.sampler_state = ss

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        w0 = time.perf_counter()
        runner.train_iteration_sync()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    # device activities only (kernels, copies, sets): one stream, so their times add up
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    device_us = sum(by_name.values())
    rnn_us = sum(e.time_range.elapsed_us() for e in on_device if "seq_cluster_kernel" in e.name or "rows_kernel" in e.name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "breakdown", "rollout_ms": (t1 - t0) * 1e3, "train_ms": (t2 - t1) * 1e3,
          "profiled_iteration_ms": wall_us / 1e3, "device_busy_ms": device_us / 1e3,
          "device_idle_share_profiled": 1.0 - device_us / wall_us,
          "device_idle_share_unprofiled": 1.0 - device_us / ((t2 - t0) * 1e6),
          "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
          "rnn_kernel_share_of_device": rnn_us / device_us, "top_device_ms": {k: v / 1e3 for k, v in top}, "card": card})


def phase_lstm(torch, cuda_rnn, card, tmp):
    envs = 128
    argv = COMMON + ["--rnn_type=lstm", "--compute_dtype=float32", "--batch_size=4096", f"--num_envs={envs}",
                     f"--train_for_env_steps={envs * 32}", "--experiment=grid_battle_lstm"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    check(counts["lstm_seq"] >= 1 and counts["gru_seq"] == 0, f"LSTM path launches {counts}")

    # the trained model on the card against the same model on the CPU (plain versions)
    import copy

    import numpy as np

    model = runner.train_state.model
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 24, 24, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 512)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        before = cuda_rnn.launch_counts()["lstm_seq"]
        on_card = forward(model, "cuda")
        torch.cuda.synchronize()
        check(cuda_rnn.launch_counts()["lstm_seq"] == before + 1, "model check did not run the LSTM kernel")
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    tol = 1e-3  # float32 with TF32 off; convolution and matmul sums run in other orders on the two devices
    emit({"phase": "lstm", "envs": envs, "env_steps": runner.env_steps, "launches": counts,
          "iteration_s": [b - a for a, b in zip(times, times[1:])], "loss": stats["loss"],
          "model_card_vs_cpu_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(err <= tol, f"model on the card vs the CPU: {err} > {tol}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from sample_factory_tpu_torch.ops import cuda_rnn

    # full-precision float32 products for the comparisons (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    start = time.perf_counter()
    lib_path = cuda_rnn.build()
    cuda_rnn.load_library()
    log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    # the launch plan assumes the cluster counts that run at once (cuda_rnn.MAX_CLUSTERS)
    at_once = {}
    for kind, (T, B, H, dtype) in (("gru", MAIN_GRU), ("lstm", MAIN_LSTM)):
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
        at_once[f"{kind}_seq"] = {"clusters": plan.grid // plan.cluster,
                                  "card_runs_at_once": cuda_rnn.max_active_clusters(kind, dtype, plan)}
        check(at_once[f"{kind}_seq"]["card_runs_at_once"] >= 1, f"{kind}: no cluster of {plan} fits the card")
    emit({"phase": "build", "seconds": time.perf_counter() - start, "library": lib_path.name,
          "ptxas": [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line],
          "clusters_at_main_shapes": at_once})

    main_err = phase_parity(torch, cuda_rnn)
    timing = phase_timing(torch, cuda_rnn, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runner, gru_counts = phase_main(torch, cuda_rnn, card, tmp)
        phase_breakdown(torch, runner, card)
        lstm_counts = phase_lstm(torch, cuda_rnn, card, tmp)

    launches = {"gru_seq": gru_counts["gru_seq"], "lstm_seq": lstm_counts["lstm_seq"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": main_err[name], **timing[name], "library_ms": None}
        for name in ("gru_seq", "lstm_seq")
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
