#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sample_factory_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build     compile the hand-written kernels (csrc/rnn_seq.cu, sm_90a) from the checkout
  parity    each kernel against its plain PyTorch version on the card, forward and
            gradient, float32 and bfloat16, at the main-path shape, the default width
            and odd shapes; both designs of the launch plan (cluster and rows) run; then the
            doom and dmlab paths' shapes in float32, each asserting the design its plan picks
  timing    each kernel, its plain version and the bound at the main-path shapes and the doom and
            dmlab paths' shapes, warm and with L2 flushed, beside the first design (rows) at the
            same shapes; each kernel in both dtypes at (32, 512, 256); torch.nn.GRU (cuDNN) as a
            yardstick
  main      sync PPO on grid_battle at full width (IMPALA conv, GRU-256, bf16,
            1024 envs, rollout 32) for 3 iterations through `run_rl`'s runner
  breakdown one more main-path iteration: rollout and learner times, then one under
            torch.profiler for the device's busy share and its top kernels
  lstm      the --rnn_type=lstm path (float32, 128 envs, 1 iteration), then the
            trained model on the card against the same model on the CPU
  appo      the default regime at full width: the `main` configuration without --async_rl
            (so async, a behaviour snapshot one train call behind) and with V-trace, 3
            iterations; the policy lag, and env steps/s beside the sync run's
  ant       continuous control at full width: the physics ant, MLP 256-128-64, 4096 envs,
            rollout 16, batch 32768, 4 epochs, sync; env steps/s and the rollout/learner split
  towers    the other model family through the LSTM kernel: resnet_impala, separate actor
            and critic towers, 2-layer LSTM-256, LAMB with lookahead, float32, 128 envs,
            1 iteration; the trained model on the card against a copy on the CPU
  population the `main` configuration with --num_policies=2 --with_pbt=True (unmixed: 512 envs a
            policy), 4 iterations with two PBT rounds in which policy 1 is the worst: its files,
            its shaping in the sampler state, per-policy checkpoints, and the exploit copy
            (`_replace_weights`) checked tensor by tensor on the card
  selfplay  grid_duel (2 agents) at full width: resnet_impala, GRU-512 (the default rnn_size),
            bf16, 2 policies mixed inside every env, 512 envs (1024 slots), 3 iterations; each
            policy trains on the shared trajectory masked to its slots; then one train call in
            float32 at a cut depth on the card against the same call on a CPU copy
  enjoy     `enjoy` on the checkpoint that `appo` wrote, on the card, 16 envs; then with
            --policy_index=1 on `population`'s
  export    `export_model` (torch.export) of `main`'s checkpoint at batch 1024 on the card; the
            reloaded program steps 1024 envs for 32 steps with its own rnn state fed back, beside
            the eager deterministic policy on the same inputs (rnn state within 0.03, equal actions
            where the top two logits differ by more); its outputs on cuda:0; ms per step of both;
            the sampling program (draws as an input) once, actions in range
  host      host envs at full width: `bench_host_pixel` (42x42x4 uint8 frames, 6 actions), 2 worker
            processes x 1024 envs in 2 splits over the shared-memory queue, rollout 32, batch 8192,
            convnet_simple + MLP 128, the default regime (async: learner quanta dispatched inside the
            rollouts, a behaviour snapshot), 6 iterations; per-slot host times; then the same
            configuration with --async_rl=False in turns with it
  host_rnn  the same with GRU-256 over BPTT segments of 32 in bf16, 3 iterations: the learner's
            `gru_seq` launches at (32, 256, 256), none in the rollout's step mode
  host_selfplay  the 2-agent matching game (a host env), 2 policies mixed inside the envs, 2 worker
            processes, PBT once: `policy_id` against the slot mapping and `active`, the mapping drawn
            anew, the mutated shaping in the workers' envs, both policies' checkpoints
  host_enjoy  `enjoy` and `eval` on the checkpoint that `host` wrote
  custom_model  `examples/train_custom_env_custom_model.py` at its own defaults (2 workers x 32 envs of the
            42x42x4 quadrant task, async, the quantized learner, its registered encoder on the card) for
            300,000 env steps: average episode reward at least 100 (random play 32); then `enjoy`
  atari     `examples/envpool/train_envpool_atari.py` (envpool_atari_breakout, atari_params: convnet_atari +
            Dense 512 over 84x84x4 uint8, sync PPO, 4 epochs of 256-sample minibatches) with 8 workers x 32
            envs in 2 splits over the stand-in envpool module of tests/standins/ (the card's machine has
            none): 4 iterations; the 4th's rollout and first epoch under the profiler, against the 3rd's
            unprofiled; uint8 frames on cuda:0, the decaying learning rate, no RNN kernel
  doom      the paper's doom_battle command line (`sf_examples_tpu/vizdoom/experiments/doom_battle_appo.py`)
            through `examples/vizdoom/train_vizdoom.py`'s flags: GRU-512 float32, convnet_simple over
            72x128x3 + the measurements MLP, the tuple head, 400 envs, batch 2048, async with the
            quantized learner, 4 iterations, over the env-level stand-in of tests/standins/ (the card's
            machine has neither gymnasium nor vizdoom); `gru_seq_rows` once a minibatch at (32, 64, 512)
  dmlab     dmlab_30 at dmlab_params (convnet_impala ++ the instruction encoder, LSTM-256 float32), 128
            envs of the port's DmlabEnv with its level cache over the stand-in deepmind_lab of
            tests/standins/, batch 1024, async, 4 iterations, the DMLab-30 score tracker registered;
            `lstm_seq` launches by site (core, instruction encoder in the rollout and the learner)
  sampler   `examples/sampler/use_simplified_sampling_api.generate_trajectories` on its fallback (no ALE):
            the synthetic env on the card for 200,000 env steps
Then a `kernels` line (each kernel's launches per path and per design: cluster, `*_seq`, and rows,
`*_seq_rows`), the card's name and power limit, and the result line.
Needs one CUDA card; exits non-zero on any failure. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
SELFPLAY_GRU = (32, 512, 512, "bfloat16")  # the selfplay phase: the default rnn_size, 512 segments a minibatch
# (32, 512, 512): the default rnn_size; (4, 16, 1024): no cluster slice fits, the row design
PARITY_SHAPES = [(32, 512, 256), (7, 24, 128), (1, 8, 128), (5, 3, 64), (32, 512, 512), (4, 16, 1024)]
# the doom and dmlab paths' shapes in the dtype each path runs, with the design its plan picks
# (kind, T, B, H, dtype, design, cluster): GRU-512 float32 over 2048 / 32 segments (16 blocks of the
# row design); the DMLab core's LSTM-256 over 1024 / 32; the instruction encoder's LSTM-64 over 16
# tokens in a rollout slot (64 envs a split), in a minibatch of 1024 (32 clusters: three waves) and
# in the learner's value of the last observation of all 128 envs
DOOM_GRU = (32, 64, 512, "float32")
DMLAB_CORE = (32, 32, 256, "float32")
DMLAB_INSTR_ROLLOUT = (16, 64, 64, "float32")
DMLAB_INSTR_LEARNER = (16, 1024, 64, "float32")
DMLAB_INSTR_BOOTSTRAP = (16, 128, 64, "float32")
PARITY_PATH_SHAPES = [("gru", *DOOM_GRU, "rows", 1), ("lstm", *DMLAB_CORE, "cluster", 8), ("lstm", *DMLAB_INSTR_ROLLOUT, "cluster", 8),
                      ("lstm", *DMLAB_INSTR_LEARNER, "cluster", 8), ("lstm", *DMLAB_INSTR_BOOTSTRAP, "cluster", 8)]
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
# each kernel has two designs (cluster: `gru_seq`/`lstm_seq`; rows: `gru_seq_rows`/`lstm_seq_rows`); the
# kernels line reports the cluster designs at their main paths' shapes, the GRU's row design at the doom
# path's (where it runs) and the LSTM's at the lstm phase's (no path runs it; the first design's shape)
KERNEL_LINE_SHAPES = {"gru_seq": ("gru", MAIN_GRU), "lstm_seq": ("lstm", MAIN_LSTM),
                      "gru_seq_rows": ("gru", DOOM_GRU), "lstm_seq_rows": ("lstm", MAIN_LSTM)}


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


def parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, plan, path_shape=False):
    """The planned kernel once against its plain version, forward and gradient."""
    args = make_inputs(torch, kind, T, B, H, dtype, seed=T + B + H)
    args = [a.requires_grad_(i != 2) for i, a in enumerate(args)]
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
          "path_shape": path_shape, "fwd_max_abs_err": fwd, "fwd_tol": tol, "grad_rel_err": grad, "grad_tol": grad_tol})
    check(fwd <= tol, f"{kind} {dtype} {(T, B, H)}: forward error {fwd} > {tol}")
    check(grad <= grad_tol, f"{kind} {dtype} {(T, B, H)}: gradient error {grad} > {grad_tol}")


def phase_parity(torch, cuda_rnn):
    fns = {"gru": (cuda_rnn.gru_seq, cuda_rnn.gru_seq_reference), "lstm": (cuda_rnn.lstm_seq, cuda_rnn.lstm_seq_reference)}
    main_err = {}
    for kind, (kernel_fn, plain_fn) in fns.items():
        for dtype in ("float32", "bfloat16"):
            for T, B, H in PARITY_SHAPES:
                parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, cuda_rnn.launch_plan(kind, T, B, H, dtype))
    for kind, T, B, H, dtype, design, cluster in PARITY_PATH_SHAPES:
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
        check(plan.design == design and plan.cluster == cluster, f"{kind} {(T, B, H, dtype)} takes {plan}, not the {design} design")
        kernel_fn, plain_fn = fns[kind]
        parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, plan, path_shape=True)
    # the error reported for each design: at the shape and dtype of the first path that runs it
    for name, (kind, (T, B, H, dtype)) in KERNEL_LINE_SHAPES.items():
        kernel_fn, plain_fn = fns[kind]
        args = make_inputs(torch, kind, T, B, H, dtype, seed=1)
        launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype) if name.endswith("_seq") else cuda_rnn.row_plan(kind, B, H)
        with torch.no_grad():
            out, state = launch(*args, plan=plan)
            torch.cuda.synchronize()
            ref_out, ref_state = plain_fn(*args)
        main_err[name] = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
        check(main_err[name] <= fwd_tol(dtype, T), f"{name} at {(T, B, H, dtype)} disagrees with its plain version")
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
    rows_by_shape = {}
    with torch.no_grad():
        # the main-path rows (and the selfplay, doom and dmlab paths' shapes): the planned design and
        # the first design (rows) at the same shape, warm and L2-cold, the plain version and the bound
        shapes = [("gru", MAIN_GRU), ("lstm", MAIN_LSTM), ("gru", SELFPLAY_GRU)] + [(k, (T, B, H, dt)) for k, T, B, H, dt, _, _ in PARITY_PATH_SHAPES]
        for kind, (T, B, H, dtype) in shapes:
            args = make_inputs(torch, kind, T, B, H, dtype, seed=2)
            plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
            rows = cuda_rnn.row_plan(kind, B, H)
            row = {"ms": time_ms(torch, lambda: launches[kind](*args)),
                   "rows_ms": time_ms(torch, lambda: launches[kind](*args, plan=rows)),
                   "plain_ms": time_ms(torch, lambda: plains[kind](*args)),
                   "ms_l2_cold": time_ms(torch, lambda: launches[kind](*args), flush=flush),
                   "rows_ms_l2_cold": time_ms(torch, lambda: launches[kind](*args, plan=rows), flush=flush)}
            bound_ms, bound_by, nbytes, flops = bound(kind, T, B, H, dtype)
            row.update(bound_ms=bound_ms, bound_by=bound_by, design=dataclasses.asdict(plan))
            rows_by_shape[(kind, T, B, H, dtype)] = row
            emit({"phase": "timing", "kernel": f"{kind}_seq", "shape": [T, B, H], "dtype": dtype, **row, "bytes": nbytes, "flops": flops,
                  "reps": REPS, "stat": "median of CUDA-event times; ms: L2 not flushed, l2_cold: 100 MB written before each; "
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
    # for the kernels line: each design at the shape of the first path that runs it (the cluster
    # designs' rows carry the row design's time there as `first_design_ms`)
    out = {}
    for name, (kind, shape) in KERNEL_LINE_SHAPES.items():
        row = rows_by_shape[(kind, *shape)]
        ms = row["ms"] if name.endswith("_seq") else row["rows_ms"]
        out[name] = {"ms": ms, "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "shape": list(shape[:3]), "dtype": shape[3]}
        if name.endswith("_seq"):
            out[name].update(design=row["design"], first_design_ms=row["rows_ms"])
    return out


def train(torch, cuda_rnn, argv, train_dir, before_run=None, observers=(), register_fn=None, device_flag=("--device=gpu",), parse=None):
    """Drive `argv` through make_rl_runner / Runner.run, as `run_rl` does, with the kernels'
    launch counts set to 0 just before the run and read just after. `before_run(runner)`
    may instrument the initialised runner; `observers` are registered before its init;
    `register_fn` registers a host env inside its worker processes; `parse` is an example's
    own argument parser (`train_synthetic`'s by default)."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.runner.runner import AlgoObserver
    from sample_factory_tpu_torch.train import make_rl_runner

    parse = parse or parse_custom_args

    class IterationClock(AlgoObserver):
        """The host time at the end of each iteration, after a sync."""

        def __init__(self):
            self.times = []

        def on_training_iteration(self, runner, stats):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())

    _, runner = make_rl_runner(parse(argv + [f"--train_dir={train_dir}", *device_flag, "--seed=0"]), register_fn=register_fn)
    clock = IterationClock()
    runner.register_observer(clock)
    for observer in observers:
        runner.register_observer(observer)
    runner.init()
    if before_run is not None:
        before_run(runner)
    torch.cuda.synchronize()
    cuda_rnn.reset_launch_counts()
    start = time.perf_counter()
    check(runner.run() == 0, "runner.run() failed")
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    stats = runner.host_stats()  # one dict, or one per policy from the population runner
    per_policy = stats if isinstance(stats, list) else [stats]
    check(per_policy and all(s and all(math.isfinite(v) for v in s.values()) for s in per_policy), f"non-finite training stats: {stats}")
    exp = os.path.join(train_dir, runner.cfg.experiment)
    check(os.path.isfile(os.path.join(exp, "config.json")), "config.json missing")
    check(os.path.isfile(os.path.join(exp, "done")), "done file missing")
    ckpts = [f for f in os.listdir(os.path.join(exp, "checkpoint_p0")) if f.startswith("checkpoint_")]
    check(len(ckpts) >= 1, "no checkpoint written")
    return runner, counts, stats, [start] + clock.times


QUIET = ["--save_every_sec=100000", "--save_best_every_sec=100000", "--experiment_summaries_interval=100000", "--num_workers=1"]
GRID_BATTLE = [
    "--env=grid_battle", "--use_rnn=True", "--rnn_size=256", "--encoder_conv_mlp_layers", "256",
    "--rollout=32", "--recurrence=32", "--num_epochs=1", "--normalize_input=True",
] + QUIET
COMMON = GRID_BATTLE + ["--async_rl=False", "--encoder_conv_architecture=convnet_impala"]
MAIN_MODEL = ["--rnn_type=gru", "--compute_dtype=bfloat16", "--batch_size=16384"]


def record_rollouts(runner, seen):
    """Wrap the runner's rollout function: note the module and the version each rollout was
    given, and the trajectory's stamps and action tensor."""
    rollout_fn = runner._rollout_fn

    def rollout(model, obs_rms, ss, version, pid):
        out = rollout_fn(model, obs_rms, ss, version, pid)
        traj = out[1]
        seen.append({"model": model, "version": int(version), "train_step": runner.train_state.train_step,
                     "stamp_min": traj["policy_version"].min(), "stamp_max": traj["policy_version"].max(),
                     "actions_shape": tuple(traj["actions"].shape), "actions_dtype": traj["actions"].dtype})
        return out

    runner._rollout_fn = rollout


def timed_iteration(torch, runner):
    """One more iteration of the runner's regime with a sync after each part (host clock):
    rollout, learner and, in the async regime, the refresh of the behaviour snapshot."""
    ts, cfg = runner.train_state, runner.cfg
    model, version = (runner.behavior_model, runner.behavior_version) if cfg.async_rl else (ts.model, ts.train_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.sampler_state, traj, _ = runner._rollout_fn(model, ts.obs_rms, runner.sampler_state, version, runner.policy_id)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner._train_fn(ts, traj, runner.train_generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"rollout_ms": (t1 - t0) * 1e3, "train_ms": (t2 - t1) * 1e3}
    if cfg.async_rl:
        with torch.no_grad():
            torch._foreach_copy_(list(runner.behavior_model.parameters()), list(ts.model.parameters()))
        runner.behavior_version = ts.train_step
        torch.cuda.synchronize()
        out["snapshot_copy_ms"] = (time.perf_counter() - t2) * 1e3
    out["env_steps_per_s"] = cfg.num_envs * cfg.rollout / (time.perf_counter() - t0)
    return out


def phase_main(torch, cuda_rnn, card, tmp):
    iters, envs = 3, 1024
    argv = COMMON + MAIN_MODEL + [f"--num_envs={envs}", f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_gru"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == 2 * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * iters}")
    check(counts["lstm_seq"] == 0, "LSTM kernel launched on the GRU path")
    steady = per_iter[1:]
    steady_rate = envs * 32 * len(steady) / sum(steady)
    emit({"phase": "main", "env": "grid_battle", "envs": envs, "rollout": 32, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_steady": steady_rate,
          "env_steps_per_s_all": runner.env_steps / sum(per_iter),
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return runner, counts, steady_rate


def device_activities(torch, prof):
    """(device busy us, RNN kernels' us, the device activities, their us by name) of a finished
    torch.profiler run that recorded the device's activities alone (kernels, copies, sets): one
    stream, so their times add up."""
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    rnn_us = sum(e.time_range.elapsed_us() for e in on_device if "seq_cluster_kernel" in e.name or "rows_kernel" in e.name)
    return sum(by_name.values()), rnn_us, on_device, by_name


def profiled_device_time(torch, fn):
    """Run fn under torch.profiler, recording CUDA activity only: (wall us, device busy us,
    RNN kernels' us, the device activities, their us by name)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    return (wall_us, *device_activities(torch, prof))


def device_share(torch, fn, unprofiled_s):
    """The device's busy time in one call of fn under the profiler, against an unprofiled
    iteration of `unprofiled_s` seconds: the profiler slows the host, not the device."""
    _, device_us, rnn_us, on_device, _ = profiled_device_time(torch, fn)
    return {"device_busy_ms": device_us / 1e3, "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
            "rnn_kernel_share_of_device": rnn_us / device_us, "device_idle_share_unprofiled": 1.0 - device_us / (unprofiled_s * 1e6)}


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

    wall_us, device_us, rnn_us, on_device, by_name = profiled_device_time(torch, runner.train_iteration_sync)
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


def median_split(splits):
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def advantage_loops_ms(torch, envs, segments, T=32, reps=10):
    """Host-clock time (synced, median) of the two reverse-time loops at the main path's
    sizes: V-trace on one minibatch [T, segments], which the async V-trace learner runs per
    minibatch, and GAE on the whole rollout [T, envs], which it skips."""
    from sample_factory_tpu_torch.algo.advantages import gae_advantages, vtrace

    def rand(*shape):
        return torch.rand(shape, device="cuda")

    def timed(fn):
        times = []
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times[2:])

    r, d, v, ratio = rand(T, segments), (rand(T, segments) < 0.05).float(), rand(T, segments), rand(T, segments) + 0.5
    gr, gd, gv, valids = rand(T, envs), (rand(T, envs) < 0.05).float(), rand(T + 1, envs), torch.ones(T + 1, envs, device="cuda")
    return {"vtrace_loop_ms_per_minibatch": timed(lambda: vtrace(r, d, v, ratio, 0.99, 1.0, 1.0)),
            "gae_loop_ms_per_rollout": timed(lambda: gae_advantages(gr, gd, gv, valids, 0.99, 0.95))}


def phase_appo(torch, cuda_rnn, card, tmp, sync_runner, sync_rate):
    """The default regime: no --async_rl flag, V-trace. The rollout of iteration k runs the
    behaviour module at the version from before train call k; each train call takes 2 SGD
    steps, so the learner sees a lag of 2 and never 0. Then the two regimes in turns
    (sync, async, async, sync, three times): the host's clock drifts by tens of percent
    within a run, so only iterations taken side by side compare."""
    iters, envs, sgd_steps = 3, 1024, 2
    argv = GRID_BATTLE + MAIN_MODEL + ["--encoder_conv_architecture=convnet_impala", "--with_vtrace=True", f"--num_envs={envs}",
                                      f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_appo"]
    seen, lags = [], []

    def before_run(runner):
        from sample_factory_tpu_torch.runner.runner import AlgoObserver

        class Lag(AlgoObserver):
            def on_training_iteration(self, runner, stats):
                lags.append(float(stats["version_diff_max"]))

        check(runner.cfg.async_rl and runner.cfg.with_vtrace and not runner.cfg.normalize_returns, "not the async V-trace regime")
        check(runner.behavior_model is not None and runner.behavior_model is not runner.train_state.model, "no behaviour snapshot")
        record_rollouts(runner, seen)
        runner.register_observer(Lag())

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == 2 * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * iters}")
    check(all(v == 0 for k, v in counts.items() if k != "gru_seq"), f"other kernels launched on the GRU path: {counts}")
    live = list(runner.train_state.model.parameters())
    snapshot = list(runner.behavior_model.parameters())
    check(all(a.data_ptr() != b.data_ptr() for a, b in zip(live, snapshot)), "the snapshot shares storage with the trained model")
    check(all(bool(torch.equal(a, b)) for a, b in zip(live, snapshot)), "the snapshot was not refreshed after the last train call")
    versions = [it["version"] for it in seen]
    check(all(it["model"] is runner.behavior_model for it in seen), "a rollout ran the trained model, not the snapshot")
    check(versions == [sgd_steps * k for k in range(iters)], f"rollout versions {versions}")
    check(all(int(it["stamp_min"]) == int(it["stamp_max"]) == it["version"] == it["train_step"] for it in seen),
          "trajectory stamps differ from the version before the train call")
    check(lags == [float(sgd_steps)] * iters, f"policy lag seen by the learner {lags}, expected {sgd_steps} each iteration")
    steady = per_iter[1:]
    rate = envs * 32 * len(steady) / sum(steady)
    turns = {"sync": [], "appo": []}
    for _ in range(3):
        for name, which in (("sync", sync_runner), ("appo", runner), ("appo", runner), ("sync", sync_runner)):
            turns[name].append(timed_iteration(torch, which))
    split = {"reps": {k: len(v) for k, v in turns.items()}, "stat": "median of iterations taken in turns, host clock, synced",
             "sync_gae": median_split(turns["sync"]), "async_vtrace": median_split(turns["appo"]),
             **advantage_loops_ms(torch, envs, 16384 // 32)}
    emit({"phase": "appo", "env": "grid_battle", "regime": "async_rl (default), with_vtrace", "envs": envs, "rollout": 32,
          "iterations": iters, "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "rollout_versions": versions, "policy_lag_sgd_steps": lags, "env_steps_per_s_steady": rate,
          "env_steps_per_s_steady_sync_main": sync_rate, "regimes_in_turns": split,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


def phase_ant(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.models.action_parameterization import ActionParameterizationDefault

    iters, envs, rollout = 2, 4096, 16
    argv = QUIET + ["--env=ant", "--use_rnn=False", "--encoder_mlp_layers", "256", "128", "64", f"--rollout={rollout}",
                    "--recurrence=1", "--batch_size=32768", "--num_epochs=4", f"--num_envs={envs}", "--async_rl=False",
                    "--normalize_input=True", "--normalize_returns=True",
                    f"--train_for_env_steps={iters * envs * rollout}", "--experiment=ant"]
    seen = []
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, lambda runner: record_rollouts(runner, seen))
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the feed-forward path: {counts}")
    check(all(it["actions_shape"] == (rollout, envs, 8) and it["actions_dtype"] == torch.float32 for it in seen),
          f"action tensors {[(it['actions_shape'], it['actions_dtype']) for it in seen]}")
    obs = runner.sampler_state.obs["obs"]
    check(tuple(obs.shape) == (envs, 59) and bool(torch.isfinite(obs).all()), "ant observations are not finite [4096, 59]")
    state = runner.sampler_state.env_states
    check(all(bool(torch.isfinite(v).all()) for k, v in state.items() if k != "steps"), "ant physics state is not finite")
    head = runner.model.action_parameterization
    check(runner.cfg.adaptive_stddev and isinstance(head, ActionParameterizationDefault)
          and head.distribution_linear.out_features == 16, "not the adaptive-stddev head (8 means + 8 log-stddevs)")
    check(runner.train_state.returns_rms is not None and runner.train_state.obs_rms is not None, "normalizers missing")
    split = median_split([timed_iteration(torch, runner) for _ in range(3)])
    emit({"phase": "ant", "env": "ant", "envs": envs, "rollout": rollout, "iterations": iters, "env_steps": runner.env_steps,
          "launches": counts, "iteration_s": per_iter, "env_steps_per_s_last": envs * rollout / per_iter[-1],
          "split_median_of_3_more_iterations": split, "epochs_executed": stats["epochs_executed"],
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


def phase_towers(torch, cuda_rnn, card, tmp):
    import copy

    import numpy as np

    envs, minibatches, layers, H = 128, 1, 2, 256
    argv = GRID_BATTLE + ["--encoder_conv_architecture=resnet_impala", "--actor_critic_share_weights=False", "--rnn_type=lstm",
                          f"--rnn_num_layers={layers}", "--optimizer=lamb", "--lamb_lookahead=True", "--compute_dtype=float32",
                          "--batch_size=4096", f"--num_envs={envs}", f"--train_for_env_steps={envs * 32}",
                          "--experiment=grid_battle_towers"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    per_minibatch = 2 * layers  # 2 towers x 2 layers, one launch each per minibatch
    check(counts["lstm_seq"] == per_minibatch * minibatches, f"LSTM kernel launches {counts}, expected {per_minibatch * minibatches}")
    check(all(v == 0 for k, v in counts.items() if k != "lstm_seq"), f"other kernels launched on the LSTM path: {counts}")
    group = runner.train_state.optimizer.param_groups[0]
    check(group["lookahead"] and group["step"] == minibatches, f"LAMB with lookahead took {group['step']} steps")

    # the trained model on the card against a deep copy on the CPU (plain versions)
    model = runner.train_state.model
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 24, 24, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 2 * layers * 2 * H)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        before = sum(cuda_rnn.launch_counts().values())
        on_card = forward(model, "cuda")
        torch.cuda.synchronize()
        check(sum(cuda_rnn.launch_counts().values()) == before + per_minibatch, "model check did not run the LSTM kernels")
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    tol = 1e-3  # float32 with TF32 off; convolution and matmul sums run in other orders on the two devices
    emit({"phase": "towers", "envs": envs, "env_steps": runner.env_steps, "launches": counts,
          "launches_per_minibatch": per_minibatch, "iteration_s": [b - a for a, b in zip(times, times[1:])],
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "model_card_vs_cpu_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(err <= tol, f"model on the card vs the CPU: {err} > {tol}")
    return counts


def worst_policy_objective(values):
    """An observer that publishes the stat `--pbt_target_objective` names, as a user's observer
    would (`policy_avg_stats`): which policy PBT finds the worst then does not hang on the luck
    of a few random-policy episodes."""
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    class Objective(AlgoObserver):
        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[v] for v in values]

    return Objective()


def policy_tensors(torch, ts):
    """Every tensor of one policy's train state: parameters, optimizer state, normalizers."""
    out = dict(ts.model.state_dict())
    for i, state in ts.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in state.items() if torch.is_tensor(v)})
    for key, rms in (ts.obs_rms or {}).items():
        out.update({f"obs_rms.{key}.{k}": v for k, v in rms.state_dict().items()})
    if ts.returns_rms is not None:
        out.update({f"returns_rms.{k}": v for k, v in ts.returns_rms.state_dict().items()})
    return out


def phase_population(torch, cuda_rnn, card, tmp):
    """Two policies, each on its own 512 envs, with PBT. A policy's 16384 env steps an iteration
    make PBT due after iterations 2 and 4 (start and period 32768 env steps a policy)."""
    iters, envs, P = 4, 1024, 2
    argv = COMMON + MAIN_MODEL + [f"--num_envs={envs}", f"--num_policies={P}", "--with_pbt=True", "--pbt_start_mutation=32768",
                                  "--pbt_period_env_steps=32768", "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5",
                                  "--pbt_replace_reward_gap=0.0", "--pbt_replace_reward_gap_absolute=0.0",
                                  f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_population"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, observers=[worst_policy_objective([1.0, 0.0])])
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(type(runner).__name__ == "MultiPolicyRunner" and not runner.mixed and runner.envs_per_policy == envs // P, "not the unmixed population runner")
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == P * iters, f"GRU kernel launches {counts['gru_seq']}, expected {P * iters} (1 a policy and iteration)")
    check(all(v == 0 for k, v in counts.items() if k != "gru_seq"), f"other kernels launched: {counts}")
    plan = cuda_rnn.launch_plan("gru", *MAIN_GRU)
    check(plan.design == "cluster", "the population's (32, 512, 256) bf16 launches do not take the cluster design")

    # PBT: policy 1 was updated; its files, its shaping where the rollout reads it, its hparams where the learner does
    exp = os.path.join(tmp, "grid_battle_population")
    check(runner.pbt.last_update == [iters * envs * 32 // P] * P, f"PBT rounds at {runner.pbt.last_update}")
    with open(os.path.join(exp, "policy_01_reward_shaping.json")) as f:
        shaping = json.load(f)
    with open(os.path.join(exp, "policy_01_cfg.json")) as f:
        hparams = json.load(f)
    check(runner.sampler_state[1].shaping == shaping and shaping != runner.env.reward_shaping, f"policy 1's shaping {runner.sampler_state[1].shaping} vs file {shaping}")
    check(runner.sampler_state[0].shaping == runner.env.reward_shaping, "policy 0's shaping moved")
    check(runner.train_state[1].hparams == hparams and hparams != runner.train_state[0].hparams, "policy 1's hparams are not the file's")
    for p in range(P):
        ckpts = [f for f in os.listdir(os.path.join(exp, f"checkpoint_p{p}")) if f.startswith("checkpoint_")]
        check(len(ckpts) >= 1, f"no checkpoint of policy {p}")
    rewards = [es.avg_reward for es in runner.episode_stats_per_policy]
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(all(r is None or math.isfinite(r) for r in rewards), f"per-policy rewards {rewards}")

    # one more iteration with a sync after each part, per policy
    split = []
    for p, ts in enumerate(runner.train_state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.sampler_state[p], traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state[p], ts.train_step, p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner._train_fn(ts, traj, runner.train_generators[p], pid=p)
        torch.cuda.synchronize()
        split.append({"policy": p, "rollout_ms": (t1 - t0) * 1e3, "train_ms": (time.perf_counter() - t1) * 1e3})

    one_more_s = sum(part["rollout_ms"] + part["train_ms"] for part in split) / 1e3
    device = device_share(torch, runner._train_iteration, one_more_s)

    # the exploit step by itself: policy 0 into policy 1, on the card
    ts0, ts1 = runner.train_state
    with torch.no_grad():
        next(ts1.model.parameters()).add_(1.0)  # they differ before the copy whatever PBT did last
    step_before = ts1.train_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.pbt._replace_weights(runner.train_state, dst=1, src=0)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    src, dst = policy_tensors(torch, ts0), policy_tensors(torch, ts1)
    check(set(src) == set(dst) and any(k.startswith("optimizer.") for k in src) and any(k.startswith("obs_rms.") for k in src),
          f"tensors of the two policies: {sorted(set(src) ^ set(dst))}")
    on_card = [k for k in src if src[k].is_cuda]
    check(len(on_card) >= len(list(ts0.model.parameters())) * 3, "parameters and moments are not on the card")
    check(all(bool(torch.equal(src[k], dst[k])) for k in src), "the exploit copy left a tensor of policy 1 different from policy 0's")
    check(all(src[k].data_ptr() != dst[k].data_ptr() for k in src), "the exploit copy shares storage between the policies")
    check(ts1.train_step == step_before + runner.cfg.max_policy_lag + 1, f"train_step {step_before} -> {ts1.train_step}")
    steady = per_iter[1:]
    emit({"phase": "population", "env": "grid_battle", "policies": P, "envs_per_policy": envs // P, "rollout": 32, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "launches_per_iteration": counts["gru_seq"] / iters, "iteration_s": per_iter,
          "env_steps_per_s_steady": envs * 32 * len(steady) / sum(steady), "split_one_more_iteration": split,
          "device_in_one_profiled_iteration": device, "exploit_copy_ms": copy_ms, "exploit_copy_tensors": len(src), "pbt_last_update": runner.pbt.last_update,
          "policy_1_hparams": hparams, "policy_1_shaping": shaping, "avg_reward": rewards, "episodes": episodes,
          "loss": [s["loss"] for s in stats], "grad_norm": [s["grad_norm"] for s in stats], "card": card})
    return counts


SELFPLAY = ["--env=grid_duel", "--encoder_conv_architecture=resnet_impala", "--use_rnn=True", "--num_policies=2",
            "--pbt_mix_policies_in_one_env=True", "--async_rl=False", "--rollout=32", "--recurrence=32", "--num_epochs=1"] + QUIET


def phase_selfplay(torch, cuda_rnn, card, tmp):
    import copy

    import numpy as np

    from sample_factory_tpu_torch.algo.learning import init_train_state

    iters, envs, P, A = 3, 512, 2, 2
    slots = envs * A
    argv = SELFPLAY + ["--compute_dtype=bfloat16", "--batch_size=16384", f"--num_envs={envs}",
                       f"--train_for_env_steps={iters * slots * 32}", "--experiment=grid_duel_selfplay"]
    seen = []

    def before_run(runner):
        rollout_fn = runner._rollout_fn

        def rollout(models, obs_rms, ss, slot_policies, versions):
            out = rollout_fn(models, obs_rms, ss, slot_policies, versions)
            want = torch.arange(slots, device=out[1]["policy_id"].device, dtype=torch.int32) % P
            seen.append({"policy_id_is_slot_mod_P": (out[1]["policy_id"] == want[None, :]).all(), "versions": list(versions),
                         "shape": tuple(out[1]["policy_id"].shape)})
            return out

        runner._rollout_fn = rollout

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    cfg = runner.cfg
    check(runner.mixed and runner.num_slots == slots and cfg.rnn_size == 512 and cfg.compute_dtype == "bfloat16", "not the mixed GRU-512 bf16 run")
    check(len(per_iter) == iters == len(seen), f"expected {iters} iterations, ran {len(per_iter)}")
    # each policy trains on all 1024 slots x 32 steps: 2 minibatches of 512 segments, so 4 launches an iteration
    check(counts["gru_seq"] == 2 * P * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * P * iters}")
    check(all(v == 0 for k, v in counts.items() if k != "gru_seq"), f"other kernels launched: {counts}")
    check(all(bool(it["policy_id_is_slot_mod_P"]) and it["shape"] == (32, slots) for it in seen), "policy_id is not slot % 2 everywhere")
    check([it["versions"] for it in seen] == [[2 * k] * P for k in range(iters)], f"rollout versions {[it['versions'] for it in seen]}")
    check(all(s["valids_fraction"] == 0.5 for s in stats), f"valids fractions {[s['valids_fraction'] for s in stats]}")
    params = [list(ts.model.parameters()) for ts in runner.train_state]
    check(all(bool(torch.isfinite(p).all()) for ps in params for p in ps), "non-finite parameters")
    check(any(not bool(torch.equal(a, b)) for a, b in zip(*params)), "the two policies' parameters are equal")
    runner._drain_ep_stats()
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(episodes[0] == episodes[1], f"per-policy episode counts {episodes}")

    # one more iteration, a sync after each part: the shared rollout, then each policy's train call
    states = runner.train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.sampler_state, traj, _ = runner._rollout_fn([ts.model for ts in states], [ts.obs_rms for ts in states], runner.sampler_state,
                                                       runner._slot_policies, [ts.train_step for ts in states])
    torch.cuda.synchronize()
    split = {"rollout_ms": (time.perf_counter() - t0) * 1e3, "train_ms": []}
    for p, ts in enumerate(states):
        t1 = time.perf_counter()
        runner._train_fn(ts, traj, runner.train_generators[p], pid=p)
        torch.cuda.synchronize()
        split["train_ms"].append((time.perf_counter() - t1) * 1e3)
    device = device_share(torch, runner._train_iteration, (split["rollout_ms"] + sum(split["train_ms"])) / 1e3)
    steady = per_iter[1:]
    emit({"phase": "selfplay", "env": "grid_duel", "policies": P, "envs": envs, "slots": slots, "rollout": 32, "rnn_size": cfg.rnn_size,
          "iterations": iters, "env_steps": runner.env_steps, "launches": counts, "launches_per_iteration": counts["gru_seq"] / iters,
          "iteration_s": per_iter, "env_steps_per_s_steady": slots * 32 * len(steady) / sum(steady), "split_one_more_iteration": split,
          "device_in_one_profiled_iteration": device, "valids_fraction": [s["valids_fraction"] for s in stats], "loss": [s["loss"] for s in stats],
          "grad_norm": [s["grad_norm"] for s in stats], "episodes": episodes, "card": card})
    del runner, states, traj, params

    # float32 at a cut depth (16 envs, 32 slots; the widths stay): one train call of policy 0 on the
    # card against the same call on a CPU copy, from the same trajectory
    small, small_slots = 16, 32
    argv = SELFPLAY + ["--compute_dtype=float32", "--batch_size=512", f"--num_envs={small}",
                       f"--train_for_env_steps={small_slots * 32}", "--experiment=grid_duel_selfplay_f32"]
    runner, f32_counts, _, _ = train(torch, cuda_rnn, argv, tmp)
    check(sum(f32_counts.values()) == 2 * P, f"float32 self-play launches {f32_counts}")
    ts = runner.train_state[0]
    cpu_model = copy.deepcopy(ts.model).cpu()
    cpu_ts = init_train_state(runner.cfg, runner.env_info, cpu_model, "cpu")
    # onto the CPU: parameters, Adam's moments, normalizers (a deep copy first: an optimizer keeps
    # the tensors it is given where device and type already match)
    cpu_ts.load_state_dict(copy.deepcopy(ts.state_dict()))
    states = runner.train_state
    runner.sampler_state, traj, _ = runner._rollout_fn([t.model for t in states], [t.obs_rms for t in states], runner.sampler_state,
                                                       runner._slot_policies, [t.train_step for t in states])
    cpu_traj = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in traj.items()}
    before = sum(cuda_rnn.launch_counts().values())
    runner._train_fn(ts, traj, runner.train_generators[0], pid=0)
    torch.cuda.synchronize()
    check(sum(cuda_rnn.launch_counts().values()) == before + 2, "the float32 train call did not launch the kernel twice")
    runner._train_fn(cpu_ts, cpu_traj, torch.Generator().manual_seed(0), pid=0)
    check(cpu_ts.train_step == ts.train_step, "the two train calls took different numbers of steps")
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(ts.model.parameters(), cpu_model.parameters()))

    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 16, 16, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 512)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))
    resets[:, 1::2] = 1.0  # every second segment reset at every step, as another policy's slots are

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        on_card = forward(ts.model, "cuda")
        torch.cuda.synchronize()
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    # float32 with TF32 off; sums run in other orders on the two devices, and Adam's first steps move a
    # parameter by about lr whatever its gradient's size, so a gradient near 0 can move it by 2 lr apart
    tol = 1e-3
    emit({"phase": "selfplay", "check": "one float32 train call of policy 0, card vs CPU copy", "envs": small, "slots": small_slots,
          "rnn_size": runner.cfg.rnn_size, "launches": f32_counts, "plan": dataclasses.asdict(cuda_rnn.launch_plan("gru", 32, 16, 512, "float32")),
          "params_max_abs_err": param_err, "model_outputs_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(param_err <= tol and err <= tol, f"card vs CPU after one train call: parameters {param_err}, outputs {err} > {tol}")
    return counts


def phase_enjoy(torch, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    cfg = parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_appo", f"--train_dir={tmp}", "--no_render"], evaluation=True)
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(cfg, num_episodes=8, num_envs=16, collect_episodes=episodes)
    check(status == 0, f"enjoy returned status {status}")
    check(len(episodes) >= 8 and math.isfinite(avg_reward), f"enjoy: {len(episodes)} episodes, average reward {avg_reward}")
    emit({"phase": "enjoy", "checkpoint_of": "appo", "envs": 16, "episodes": len(episodes), "avg_reward": avg_reward,
          "avg_len": sum(n for _, n in episodes) / len(episodes), "seconds": time.perf_counter() - start, "card": card})

    # a policy of a population, by its index
    cfg = parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_population", f"--train_dir={tmp}", "--no_render",
                             "--policy_index=1"], evaluation=True)
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(cfg, num_episodes=8, num_envs=16, collect_episodes=episodes)
    check(status == 0 and len(episodes) >= 8 and math.isfinite(avg_reward), f"enjoy --policy_index=1: status {status}, {len(episodes)} episodes")
    emit({"phase": "enjoy", "checkpoint_of": "population", "policy_index": 1, "envs": 16, "episodes": len(episodes),
          "avg_reward": avg_reward, "seconds": time.perf_counter() - start, "card": card})


EXPORT_BATCH = 1024
EXPORT_STEPS = 32
EXPORT_TOL = 0.03  # the bf16 tolerance of tests/test_torch_models.py


def phase_export(torch, card, tmp):
    """`export_model` on `main`'s checkpoint (grid_battle, convnet_impala + Dense 256, GRU-256,
    bf16) at batch 1024 on the card; the reloaded program steps 1024 envs for 32 steps with
    its own rnn state fed back, beside the eager deterministic policy on the same inputs."""
    from sample_factory_tpu_torch.algo.sampling import init_sampler_state, normalize_obs
    from sample_factory_tpu_torch.envs.device_env import autoreset_step
    from sample_factory_tpu_torch.envs.env_utils import create_env
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.export_model import build_inference_fn, export_model, load_exported_model, load_policy
    from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state

    def export_cfg(deterministic):
        return parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_gru", f"--train_dir={tmp}",
                                  f"--eval_deterministic={deterministic}"], evaluation=True)

    torch.cuda.synchronize()
    start = phase_start = time.perf_counter()
    path = export_model(export_cfg(True), batch_size=EXPORT_BATCH, output_path=os.path.join(tmp, "policy_greedy.pt2"))
    export_s = time.perf_counter() - start
    program = load_exported_model(path)
    cfg, env_info, ts = load_policy(export_cfg(True))
    eager = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=True)
    check(cfg.compute_dtype == "bfloat16" and cfg.rnn_size == 256, f"export: not main's model ({cfg.compute_dtype}, {cfg.rnn_size})")

    env = create_env(cfg.env, cfg=cfg)
    generator = torch.Generator("cuda").manual_seed(7)
    ss = init_sampler_state(cfg, env, EXPORT_BATCH, torch.device("cuda"), generator)
    rnn = initial_actor_critic_state(cfg, EXPORT_BATCH, "cuda")
    rnn_err, mismatched, ties, decided = 0.0, 0, 0, 0
    with torch.no_grad():
        for _ in range(EXPORT_STEPS):
            obs = {k: v.float() for k, v in ss.obs.items()}
            actions, new_rnn = program(obs, rnn)
            check(actions.device == torch.device("cuda", 0) and new_rnn.device == torch.device("cuda", 0),
                  f"export: outputs on {actions.device} and {new_rnn.device}")
            eager_actions, eager_rnn = eager(obs, rnn)
            rnn_err = max(rnn_err, float((new_rnn - eager_rnn).abs().max()))
            logits = eager.model(normalize_obs(cfg, eager.obs_rms, obs), rnn)[0].float()
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > EXPORT_TOL
            mismatched += int(((actions != eager_actions)[:, 0] & clear).sum())
            ties += int((~clear).sum())
            decided += int(clear.sum())
            ss.obs, ss.env_states, _, dones, _ = autoreset_step(env, ss.env_states, actions, generator=generator)
            rnn = torch.where(dones[:, None].bool(), torch.zeros_like(new_rnn), new_rnn)
        torch.cuda.synchronize()
        check(rnn_err <= EXPORT_TOL, f"export: rnn state {rnn_err} from the eager policy's (tol {EXPORT_TOL})")
        check(mismatched == 0, f"export: {mismatched} of {decided} clear actions differ from the eager policy's")

        obs = {k: v.float() for k, v in ss.obs.items()}
        ms = time_ms(torch, lambda: program(obs, rnn))
        eager_ms = time_ms(torch, lambda: eager(obs, rnn))

        # a sampling policy takes its draws as its third input
        sampling_path = export_model(export_cfg(False), batch_size=EXPORT_BATCH, output_path=os.path.join(tmp, "policy_sampling.pt2"))
        sampler = load_exported_model(sampling_path)
        noise = torch.rand((EXPORT_BATCH, eager.noise_width), generator=generator, device="cuda")
        sampled, sampled_rnn = sampler(obs, rnn, noise)
        torch.cuda.synchronize()
        n_actions = env_info.action_space.n
        check(sampled.shape == (EXPORT_BATCH, 1) and sampled.dtype == torch.int32 and sampled.device == torch.device("cuda", 0),
              f"export: sampled actions {tuple(sampled.shape)} {sampled.dtype} on {sampled.device}")
        check(0 <= int(sampled.min()) and int(sampled.max()) < n_actions, "export: sampled actions out of range")
        check(bool(torch.isfinite(sampled_rnn).all()), "export: non-finite rnn state from the sampling program")
        sampled_share = float((sampled != program(obs, rnn)[0]).float().mean())
    emit({"phase": "export", "checkpoint_of": "main", "batch": EXPORT_BATCH, "steps": EXPORT_STEPS, "export_s": export_s,
          "pt2_bytes": os.path.getsize(path), "rnn_max_abs_err": rnn_err, "tol": EXPORT_TOL, "tie_share": ties / (ties + decided),
          "clear_actions": decided, "mismatched_clear_actions": mismatched, "ms_per_exported_step": ms, "ms_per_eager_step": eager_ms,
          "sampled_actions_not_greedy_share": sampled_share, "phase_s": time.perf_counter() - phase_start, "reps": REPS,
          "stat": "median of CUDA-event times after warm-up, a spin of the card before each", "card": card})


# ------------------------------------------------------------------ host envs

QUIET_HOST = [a for a in QUIET if a != "--num_workers=1"]
HOST_PIXEL = ["--env=bench_host_pixel", "--num_workers=2", "--num_envs_per_worker=1024", "--worker_num_splits=2", "--rollout=32",
              "--batch_size=8192", "--num_epochs=1", "--encoder_conv_architecture=convnet_simple", "--encoder_conv_mlp_layers", "128",
              "--normalize_input=True", "--decorrelate_envs_on_one_worker=False"] + QUIET_HOST
HOST_SLOTS, HOST_ENVS, HOST_OBS_BYTES = 64, 2048, 42 * 42 * 4  # (timestep, split) slots a rollout; envs; bytes a frame stack


def shm_segments():
    """This process's host-sampler segments still in /dev/shm (ShmSlabs names them sftpu_<pid>_...)."""
    return [n for n in os.listdir("/dev/shm") if n.startswith(f"sftpu_{os.getpid()}_")]


def record_host_rollouts(runner, seen):
    """Wrap the host sampler's collect_rollout: what each rollout was given and what came out."""
    collect = runner.sampler.collect_rollout

    def recording_collect(model, obs_rms, version, *args, **kwargs):
        q = runner._quantizer
        dispatched_before = (q.total_quanta_enqueued - q.pending) if q is not None else 0
        traj, stats = collect(model, obs_rms, version, *args, **kwargs)
        tensors = {**{f"obs/{k}": v for k, v in traj["obs"].items()}, **{k: v for k, v in traj.items() if k != "obs"}}
        seen.append({"model": model, "version": version, "behavior_version_host": runner._behavior_version_host,
                     "devices": {str(v.device) for v in tensors.values()}, "obs_dtype": traj["obs"]["obs"].dtype,
                     "obs_shape": tuple(traj["obs"]["obs"].shape), "stamp_min": traj["policy_version"].min(), "stamp_max": traj["policy_version"].max(),
                     "quanta_in_rollout": ((q.total_quanta_enqueued - q.pending) - dispatched_before) if q is not None else 0,
                     "episodes": stats["count"]})
        return traj, stats

    runner.sampler.collect_rollout = recording_collect


def slot_ms(sampler):
    return {k: 1e3 * v / max(1, sampler.slots_timed) for k, v in sampler.slot_seconds.items()}


def reset_slot_timers(sampler):
    sampler.slot_seconds = dict.fromkeys(sampler.slot_seconds, 0.0)
    sampler.slots_timed = 0


def host_run(torch, cuda_rnn, tmp, argv, iters, experiment):
    """One run of the host path through make_rl_runner -> init -> run with no --device flag."""
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    seen, initial, workers = [], [], []

    class SteadyTimers(AlgoObserver):
        """The per-slot timers count from the second iteration on."""

        def __init__(self):
            self.iterations = 0

        def on_training_iteration(self, runner, stats):
            self.iterations += 1
            if self.iterations == 1:
                reset_slot_timers(runner.sampler)

    def before_run(runner):
        check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda", "not the host runner on the card")
        check(runner.sampler.transport == "shm_queue", f"transport {runner.sampler.transport}: the shared-memory queue did not build")
        check(runner.cfg.async_rl and runner._quantizer is not None, "not the default regime with the quantized learner")
        check(runner.behavior_model is not None and runner.behavior_model is not runner.train_state.model, "no behaviour snapshot")
        check(len(runner.sampler.workers) == 2 and all(p.is_alive() for p in runner.sampler.workers), "worker processes are not running")
        check(len(shm_segments()) >= 6, f"shared-memory slabs: {shm_segments()}")
        initial.extend(p.detach().clone() for p in runner.train_state.model.parameters())
        workers.extend(runner.sampler.workers)
        record_host_rollouts(runner, seen)

    full = argv + [f"--train_for_env_steps={iters * HOST_ENVS * 32}", f"--experiment={experiment}"]
    runner, counts, stats, times = train(torch, cuda_rnn, full, tmp, before_run, observers=[SteadyTimers()],
                                         register_fn=register_bench_pixel, device_flag=())
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters == len(seen), f"expected {iters} iterations, ran {len(per_iter)}")
    q, sgd = runner._quantizer, runner._quantizer.sgd_steps_per_train
    check(sgd == 8 and q.num_minibatches == 8, f"{q.num_minibatches} minibatches a train step")
    for k, it in enumerate(seen):
        check(it["model"] is runner.behavior_model, "a rollout ran the trained model, not the snapshot")
        check(it["devices"] == {"cuda:0"}, f"trajectory tensors on {it['devices']}")
        check(it["obs_dtype"] == torch.uint8 and it["obs_shape"] == (33, HOST_ENVS, 42, 42, 4), f"observations {it['obs_dtype']} {it['obs_shape']}")
        check(int(it["stamp_min"]) == int(it["stamp_max"]) == it["version"] == it["behavior_version_host"] == sgd * max(0, k - 1),
              f"rollout {k}: stamps {int(it['stamp_min'])}..{int(it['stamp_max'])}, version {it['version']}")
    in_rollouts = q.total_quanta_enqueued - q.quanta_drained_at_flush
    check(q.total_quanta_enqueued == iters * (sgd + 2), f"{q.total_quanta_enqueued} quanta queued")
    check(all(it["quanta_in_rollout"] == sgd + 2 for it in seen[1:]) and seen[0]["quanta_in_rollout"] == 0 and in_rollouts == (iters - 1) * (sgd + 2),
          f"quanta inside rollouts {[it['quanta_in_rollout'] for it in seen]}, at flush {q.quanta_drained_at_flush}")
    check(runner.train_state.train_step == runner._version_host == iters * sgd, f"train_step {runner.train_state.train_step}, mirror {runner._version_host}")
    params = list(runner.train_state.model.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in params), "non-finite parameters")
    check(all(not bool(torch.equal(a, b)) for a, b in zip(params, initial)), "a parameter did not change")
    check(all(not p.is_alive() for p in workers), "a worker process outlived the run")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    return runner, counts, stats, per_iter, seen


def phase_host(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.train import make_rl_runner

    iters = 6
    runner, counts, stats, per_iter, seen = host_run(torch, cuda_rnn, tmp, HOST_PIXEL + ["--use_rnn=False"], iters, "host_pixel")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the feed-forward host path: {counts}")
    steady = per_iter[1:]
    q = runner._quantizer
    emit({"phase": "host", "env": "bench_host_pixel", "workers": 2, "envs": HOST_ENVS, "splits": 2, "rollout": 32, "batch": 8192,
          "transport": runner.sampler.transport, "iterations": iters, "env_steps": runner.env_steps, "launches": counts,
          "iteration_s": per_iter, "env_steps_per_s_steady": HOST_ENVS * 32 * len(steady) / sum(steady),
          "upload_bytes_per_iteration": 33 * HOST_ENVS * HOST_OBS_BYTES,
          "slot_ms_host_clock_iterations_2_on": slot_ms(runner.sampler), "slots_timed": runner.sampler.slots_timed,
          "quanta_per_train_step": q.sgd_steps_per_train + 2, "quanta_in_rollouts": q.total_quanta_enqueued - q.quanta_drained_at_flush,
          "quanta_at_flush": q.quanta_drained_at_flush, "rollout_versions": [it["version"] for it in seen],
          "policy_lag_sgd_steps": stats["version_diff_max"], "timing": runner.timing.flat_str(),
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    del runner

    # the two regimes in turns (sync, async, async, sync, three times), each on its own workers
    runners = {}
    try:
        for name in ("sync", "async"):
            argv = HOST_PIXEL + ["--use_rnn=False", f"--async_rl={name == 'async'}", "--train_for_env_steps=1000000000",
                                 f"--experiment=host_pixel_turns_{name}", f"--train_dir={tmp}", "--seed=0"]
            _, runners[name] = make_rl_runner(parse_custom_args(argv), register_fn=register_bench_pixel)
            runners[name].init()
            check(runners[name].sampler.transport == "shm_queue", "the turns do not run over the shared-memory queue")

        # the learner's share of an iteration on the host's clock: the fused train call (sync), or
        # the quanta that the pacer dispatches between the rollout's slots (async)
        learner_s = {"sync": 0.0, "async": 0.0}

        def clocked(name, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                learner_s[name] += time.perf_counter() - t0
                return out
            return call

        runners["sync"]._train_fn = clocked("sync", runners["sync"]._train_fn)
        pacer = runners["async"]._pacer
        pacer.q.dispatch_one = clocked("async", pacer.q.dispatch_one)

        def timed(name):
            reset_slot_timers(runners[name].sampler)
            learner_s[name] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runners[name]._train_iteration()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            slots = slot_ms(runners[name].sampler)
            return {"iteration_ms": seconds * 1e3, "env_steps_per_s": HOST_ENVS * 32 / seconds,
                    "slots_ms": HOST_SLOTS * sum(slots.values()), "learner_host_ms": learner_s[name] * 1e3,
                    **{f"slot_{k}_ms": v for k, v in slots.items()}}

        for name in ("sync", "async", "async"):  # warm-up; the async runner needs a train step under way
            timed(name)
        turns = {"sync": [], "async": []}
        for _ in range(3):
            for name in ("sync", "async", "async", "sync"):
                turns[name].append(timed(name))
        split = {name: median_split(rows) for name, rows in turns.items()}
        device = device_share(torch, runners["async"]._train_iteration, split["async"]["iteration_ms"] / 1e3)
        qa = runners["async"]._quantizer
        check(qa.quanta_drained_at_flush == 0 and qa.total_quanta_enqueued > qa.pending, "the async runner in turns drained quanta at a flush")
        # one train step quantum by quantum, nothing else on the card: the host's time to dispatch
        # each, and the time until the device has finished it
        a = runners["async"]
        qa.flush()
        traj, _ = a.sampler.collect_rollout(a.behavior_model, a.behavior_obs_rms, a._behavior_version_host, a.policy_id)
        torch.cuda.synchronize()
        qa.enqueue(a.train_state, traj, a.train_generator)
        quanta = []
        while qa.pending:
            t0 = time.perf_counter()
            qa.dispatch_one()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            quanta.append({"host_ms": (t1 - t0) * 1e3, "until_device_done_ms": (time.perf_counter() - t0) * 1e3})
        a._version_host += qa.sgd_steps_per_train
        a._pending = False
        emit({"phase": "host", "check": "the regimes in turns", "reps": {k: len(v) for k, v in turns.items()},
              "stat": "median of iterations taken in turns, host clock, synced; slot times are host-clock ms per (timestep, split), "
                      "slots_ms their sum over the rollout's 64 slots, learner_host_ms the host's time in the train call (sync) or in the quanta (async)",
              "sync_fused_train_call": split["sync"], "async_quantized": split["async"],
              "async_over_sync_rate": split["async"]["env_steps_per_s"] / split["sync"]["env_steps_per_s"],
              "device_in_one_profiled_async_iteration": device,
              "one_train_step_quantum_by_quantum": {"order": "prepare, 8 sgd, lr", "host_ms": [q["host_ms"] for q in quanta],
                                                    "until_device_done_ms": [q["until_device_done_ms"] for q in quanta]}, "card": card})
    finally:
        for r in runners.values():
            r._finish_pending_work()
            r._release_resources()
            r._close_writers()
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    return counts


HOST_GRU = (32, 256, 256, "bfloat16")  # the host_rnn phase: 8192 / 32 segments a minibatch


def phase_host_rnn(torch, cuda_rnn, card, tmp):
    iters, minibatches = 3, 8
    plan = cuda_rnn.launch_plan("gru", *HOST_GRU)
    check(plan.design == "cluster" and plan.cluster == 8, f"(32, 256, 256) bf16 takes {plan}")
    argv = HOST_PIXEL + ["--use_rnn=True", "--rnn_size=256", "--recurrence=32", "--compute_dtype=bfloat16"]
    runner, counts, stats, per_iter, seen = host_run(torch, cuda_rnn, tmp, argv, iters, "host_pixel_gru")
    # every queued train step ran (two inside rollouts, the last at the final flush): 8 launches each, in the learner only
    check(counts["gru_seq"] == minibatches * iters, f"GRU kernel launches {counts['gru_seq']}, expected {minibatches * iters}")
    check(all(v == 0 for k, v in counts.items() if k != "gru_seq"), f"other kernels launched on the host GRU path: {counts}")
    check(tuple(runner.sampler.rnn_states[0].shape) == (1024, 256), "the sampler's rnn state is not [1024, 256]")
    args = make_inputs(torch, "gru", *HOST_GRU, seed=4)
    with torch.no_grad():
        kernel_ms = time_ms(torch, lambda: cuda_rnn._launch_gru(*args))
        plain_ms = time_ms(torch, lambda: cuda_rnn.gru_seq_reference(*args))
        out, state = cuda_rnn._launch_gru(*args)
        ref_out, ref_state = cuda_rnn.gru_seq_reference(*args)
    err = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
    check(err <= fwd_tol("bfloat16", 32), f"gru_seq at (32, 256, 256) bf16 disagrees with its plain version: {err}")
    bound_ms, bound_by, nbytes, flops = bound("gru", *HOST_GRU)
    steady = per_iter[1:]
    emit({"phase": "host_rnn", "env": "bench_host_pixel", "envs": HOST_ENVS, "rollout": 32, "rnn_size": 256, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "launches_per_train_step": minibatches, "iteration_s": per_iter,
          "env_steps_per_s_steady": HOST_ENVS * 32 * len(steady) / sum(steady), "slot_ms_host_clock_iterations_2_on": slot_ms(runner.sampler),
          "kernel_shape": list(HOST_GRU[:3]), "dtype": HOST_GRU[3], "design": dataclasses.asdict(plan), "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "reps": REPS,
          "timing": runner.timing.flat_str(), "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


def phase_host_selfplay(torch, cuda_rnn, card, tmp):
    """Smoke depth: the matching game (2 agents an env; pure numpy, its spaces in the port's own
    specs), 2 policies mixed inside the envs, 2 worker processes, async (the default), PBT due
    once, after iteration 3 (384 agent steps a policy), with policy 1 the worst."""
    from sample_factory_tpu_torch.examples import train_custom_multi_env as game

    game.register_custom_components()
    iters, slots, rollout, P = 5, 32, 16, 2
    per_iter = slots * rollout
    argv = QUIET_HOST + [f"--env={game.ENV_NAME}", "--num_policies=2", "--num_workers=2", "--num_envs_per_worker=8", "--worker_num_splits=2",
                         f"--rollout={rollout}", "--batch_size=256", "--encoder_mlp_layers", "64", "64", "--use_rnn=False",
                         "--custom_env_episode_len=4", "--pbt_mix_policies_in_one_env=True", "--with_pbt=True",
                         f"--pbt_start_mutation={3 * per_iter // 2}", f"--pbt_period_env_steps={3 * per_iter // 2}", "--pbt_mutation_rate=1.0",
                         "--pbt_replace_fraction=0.5", "--pbt_replace_reward_gap=0.0", "--pbt_replace_reward_gap_absolute=0.0",
                         f"--train_for_env_steps={iters * per_iter}", "--experiment=host_selfplay"]
    seen, pushed, workers = [], [], []

    def before_run(runner):
        check(type(runner).__name__ == "HostMultiPolicyRunner" and runner.device.type == "cuda", "not the host multi-policy runner on the card")
        check(runner.sampler.transport == "shm_queue" and runner.sampler.num_envs == slots and runner.env_info.num_agents == 2, "not 32 agent slots over the shared-memory queue")
        workers.extend(runner.sampler.workers)
        sampler = runner.sampler
        collect, finish, push = sampler.collect_rollout, sampler._finish_trajectory, sampler.set_reward_shaping
        active = []

        def recording_finish(*args):
            active.append(torch.as_tensor(sampler._host_buf["active"].copy()))
            return finish(*args)

        def recording_collect(models, obs_rms, versions, **kwargs):
            traj, stats = collect(models, obs_rms, versions, **kwargs)
            seen.append({"traj": traj, "slot_policies": kwargs["slot_policies"].copy(), "active": active.pop(), "iteration": len(seen),
                         "behaviour": models is runner.behavior_models})
            return traj, stats

        def recording_push(shaping, slot_mask=None):
            pushed.append({"shaping": dict(shaping), "mask": slot_mask.copy(), "after_iteration": len(seen)})
            return push(shaping, slot_mask)

        sampler._finish_trajectory, sampler.collect_rollout, sampler.set_reward_shaping = recording_finish, recording_collect, recording_push

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, observers=[worst_policy_objective([1.0, 0.0])],
                                         register_fn=game.register_custom_components, device_flag=())
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched: {counts}")
    check(len(seen) == iters and all(it["behaviour"] for it in seen), f"{len(seen)} rollouts, or one ran the trained modules")
    for it in seen:
        pid = it["traj"]["policy_id"].cpu()
        flat = torch.as_tensor(it["slot_policies"].reshape(-1))[None].expand_as(pid)
        inactive = it["active"] == 0
        check(str(it["traj"]["policy_id"].device) == "cuda:0" and bool((pid[~inactive] == flat[~inactive]).all()), "policy_id differs from the slot's policy")
        check(bool((pid[inactive] == -1).all()) and bool(((pid == -1) == inactive).all()), "policy_id is -1 elsewhere than on inactive agents")
    check(bool(seen[0]["active"][:2].eq(0).all()) and int((seen[0]["active"] == 0).sum()) >= 2 * slots, "the agents did not sit out their first steps")
    check(runner.mapping_resamples >= 1, "the agent-policy mapping was never drawn anew")
    check(all(0.0 < s["valids_fraction"] < 1.0 for s in stats) and sum(s["valids_fraction"] for s in stats) <= 1.0 + 1e-6,
          f"valids fractions {[s['valids_fraction'] for s in stats]}")
    # PBT ran once: policy 1's mutated penalty went to the workers' envs, for the agents it drove then
    exp = os.path.join(tmp, "host_selfplay")
    with open(os.path.join(exp, "policy_01_reward_shaping.json")) as f:
        shaping = json.load(f)
    check(len(pushed) == 1 and pushed[0]["shaping"] == shaping and shaping["rew"] != -1.0, f"shaping pushed {pushed}, file {shaping}")
    mask = torch.as_tensor(pushed[0]["mask"].reshape(-1))
    check(0 < int(mask.sum()) < slots, "the shaping mask selects no slot, or all")
    later = [it for it in seen if it["iteration"] >= pushed[0]["after_iteration"]]
    check(len(later) >= 2, "no rollout after the PBT round")
    for it in later:
        rewards = it["traj"]["rewards"].cpu()
        paid_new = {round(float(v), 5) for v in rewards[:, mask].unique()}
        paid_old = {round(float(v), 5) for v in rewards[:, ~mask].unique()}
        check(paid_new <= {0.0, round(shaping["rew"], 5)} and round(shaping["rew"], 5) in paid_new, f"rewards of the reshaped agents {paid_new}, shaping {shaping}")
        check(paid_old <= {0.0, -1.0} and -1.0 in paid_old, f"rewards of the other agents {paid_old}")
    for p in range(P):
        ckpts = [f for f in os.listdir(os.path.join(exp, f"checkpoint_p{p}")) if f.startswith("checkpoint_")]
        check(len(ckpts) >= 1, f"no checkpoint of policy {p}")
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(sum(episodes) == iters * slots * (rollout // 4) and all(n > 0 for n in episodes), f"episodes credited {episodes}")
    check(all(not p.is_alive() for p in workers) and not shm_segments(), "a worker or a shared-memory segment outlived the run")
    per_iter_s = [b - a for a, b in zip(times, times[1:])]
    emit({"phase": "host_selfplay", "env": game.ENV_NAME, "policies": P, "agent_slots": slots, "rollout": rollout, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter_s, "mapping_resamples": runner.mapping_resamples,
          "valids_fraction": [s["valids_fraction"] for s in stats], "policy_1_shaping": shaping, "reshaped_slots": int(mask.sum()),
          "pbt_after_iteration": pushed[0]["after_iteration"], "episodes_credited": episodes,
          "inactive_share": float(sum(float((it["active"] == 0).float().mean()) for it in seen) / iters),
          "loss": [s["loss"] for s in stats], "card": card})
    return counts


def phase_host_enjoy(torch, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.eval import do_eval
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    base = ["--env=bench_host_pixel", "--experiment=host_pixel", f"--train_dir={tmp}"]
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(parse_custom_args(base + ["--no_render", "--max_num_episodes=2"], evaluation=True), collect_episodes=episodes)
    check(status == 0 and len(episodes) == 2 and avg_reward == 512.0, f"enjoy on the host env: status {status}, episodes {episodes}")
    enjoy_s = time.perf_counter() - start
    # eval through the worker pool, at a cut depth: 2 workers x 64 envs (episodes last 512 steps)
    start = time.perf_counter()
    status = do_eval(parse_custom_args(base + ["--sample_env_episodes=64", "--num_envs_per_worker=64"], evaluation=True), register_fn=register_bench_pixel)
    with open(os.path.join(tmp, "host_pixel", "eval", "eval_p0.csv")) as f:
        rows = f.read().strip().splitlines()
    check(status == 0 and len(rows) == 65 and rows[1] == "0,512.0,512", f"eval on the host env: status {status}, {len(rows)} rows")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "host_enjoy", "checkpoint_of": "host", "enjoy_episodes": len(episodes), "avg_reward": avg_reward, "enjoy_seconds": enjoy_s,
          "eval_episodes": len(rows) - 1, "eval_seconds": time.perf_counter() - start, "card": card})


# ------------------------------------------------------------------ the examples users start from

CUSTOM_MODEL_STEPS, CUSTOM_MODEL_MIN_REWARD = 300_000, 100.0  # random play 32 an episode, perfect 128


@contextlib.contextmanager
def restored_encoder_factory():
    """A phase that registers an example's encoder factory leaves the previous one in place after it:
    the factory is global, and the later phases build their own encoders."""
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    previous = factory.encoder_factory
    try:
        yield
    finally:
        factory.encoder_factory = previous


def check_host_example(runner, workers, encoder_cls):
    model = runner.train_state.model
    check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda", "not the host runner on the card")
    check(runner.sampler.transport == "shm_queue" and len(runner.sampler.workers) == workers, f"{len(runner.sampler.workers)} workers")
    check(runner.cfg.async_rl and runner._quantizer is not None, "not the default regime with the quantized learner")
    check(isinstance(model.encoder, encoder_cls) and isinstance(runner.behavior_model.encoder, encoder_cls),
          f"the encoder is {type(model.encoder).__name__}, not the example's")
    check({str(p.device) for p in model.parameters()} == {"cuda:0"}, "the model's parameters are not all on cuda:0")


def phase_custom_model(torch, cuda_rnn, card, tmp):
    """`examples/train_custom_env_custom_model.py` at its own defaults (2 workers x 32 envs, 2 splits,
    rollout 32, batch 1024, async with the quantized learner, normalize_input): the registered
    encoder on the card, trained to an average episode reward of at least 100; then `enjoy`."""
    with restored_encoder_factory():
        return custom_model_run(torch, cuda_rnn, card, tmp)


def custom_model_run(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples import train_custom_env_custom_model as pixel
    from sample_factory_tpu_torch.examples.custom_encoders import CustomPixelEncoder

    pixel.register_custom_components()
    seen = []

    def before_run(runner):
        check_host_example(runner, 2, CustomPixelEncoder)
        check(runner.cfg.normalize_input, "not the example's defaults")
        record_host_rollouts(runner, seen)

    argv = QUIET_HOST + ["--env=my_custom_pixel_env", f"--train_for_env_steps={CUSTOM_MODEL_STEPS}", "--experiment=custom_model"]
    start = time.perf_counter()
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=pixel.register_custom_components,
                                         parse=pixel.parse_custom_args)
    seconds = time.perf_counter() - start
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on a feed-forward path: {counts}")
    envs = runner.sampler.num_envs
    check(envs == 64 and runner.cfg.rollout == 32 and runner.cfg.batch_size == 1024, f"{envs} envs, not the example's 2 x 32")
    check(all(it["devices"] == {"cuda:0"} and it["obs_dtype"] == torch.uint8 and it["obs_shape"] == (33, envs, 42, 42, 4) for it in seen),
          "observations did not arrive on cuda:0 as uint8 [33, 64, 42, 42, 4]")
    reward = runner.episode_stats.avg_reward
    check(reward is not None and reward >= CUSTOM_MODEL_MIN_REWARD, f"average episode reward {reward} after {runner.env_steps} env steps")
    per_iter = [b - a for a, b in zip(times, times[1:])]

    episodes = []
    enjoy_start = time.perf_counter()
    status, enjoy_reward = enjoy(pixel.parse_custom_args(["--env=my_custom_pixel_env", "--experiment=custom_model", f"--train_dir={tmp}",
                                                          "--no_render", "--max_num_episodes=4"], evaluation=True), collect_episodes=episodes)
    check(status == 0 and len(episodes) == 4 and all(n == pixel.EPISODE_LEN for _, n in episodes), f"enjoy: status {status}, {episodes}")
    check(enjoy_reward >= CUSTOM_MODEL_MIN_REWARD, f"enjoy's average reward {enjoy_reward}")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "custom_model", "env": "my_custom_pixel_env", "encoder": "CustomPixelEncoder", "workers": 2, "envs": envs, "rollout": 32,
          "transport": runner.sampler.transport, "iterations": len(per_iter), "env_steps": runner.env_steps, "seconds": seconds,
          "env_steps_per_s": runner.env_steps / sum(per_iter), "avg_episode_reward": reward, "min_reward": CUSTOM_MODEL_MIN_REWARD,
          "enjoy_episodes": len(episodes), "enjoy_avg_reward": enjoy_reward, "enjoy_seconds": time.perf_counter() - enjoy_start,
          "launches": counts, "timing": runner.timing.flat_str(), "card": card})
    return counts


STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "standins")  # envpool, vizdoom, deepmind_lab
ATARI_FRAME_BYTES = 84 * 84 * 4


@contextlib.contextmanager
def standins_on_path(*modules):
    """tests/standins/ on sys.path and PYTHONPATH (spawned workers import the stand-ins from there);
    `modules` are dropped from sys.modules afterwards."""
    old_path = os.environ.get("PYTHONPATH")
    sys.path.insert(0, STANDIN_DIR)
    os.environ["PYTHONPATH"] = STANDIN_DIR + (os.pathsep + old_path if old_path else "")
    try:
        yield
    finally:
        sys.path.remove(STANDIN_DIR)
        for name in modules:
            sys.modules.pop(name, None)
        if old_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old_path


def phase_atari(torch, cuda_rnn, card, tmp):
    """`examples/envpool/train_envpool_atari.py` with --env=envpool_atari_breakout on the atari_params
    defaults and the module's usage line (32 envs a worker in 2 splits), over the stand-in envpool
    module of `tests/standins/`, which the workers import from the path: 4 iterations. The window
    from the start of an iteration to its first epoch's last SGD step is timed in every iteration,
    and in the 4th it runs under the profiler."""
    from sample_factory_tpu_torch.examples.envpool import train_envpool_atari as atari

    workers = min(8, os.cpu_count() or 1)
    envs, rollout, iters = workers * 32, 128, 4
    epoch_steps = envs * rollout // 256
    atari.register_envpool_atari_components()
    calls, rollouts, profile, slots = [], [], {}, {}
    window = {"t0": None, "steps": 0, "prof": None, "ms": []}

    def end_of_first_epoch(optimizer, args, kwargs):
        window["steps"] += 1
        if window["steps"] != epoch_steps:
            return
        torch.cuda.synchronize()
        window["ms"].append((time.perf_counter() - window["t0"]) * 1e3)
        prof, window["prof"] = window["prof"], None
        if prof is not None:
            stop = time.perf_counter()
            prof.stop()
            device_us, _, on_device, by_name = device_activities(torch, prof)
            profile.update(wall_ms=window["ms"][-1], device_us=device_us, activities=len(on_device), stop_s=time.perf_counter() - stop,
                           top={k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]})

    def before_run(runner):
        cfg = runner.cfg
        check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda" and not cfg.async_rl, "not sync PPO on the card")
        check(runner.sampler.transport == "shm_queue" and len(runner.sampler.workers) == workers, f"{len(runner.sampler.workers)} workers")
        check(cfg.encoder_conv_architecture == "convnet_atari" and cfg.obs_scale == 255.0 and cfg.normalize_input and cfg.normalize_returns
              and cfg.lr_schedule == "linear_decay" and cfg.adam_eps == 1e-5 and cfg.batch_size == 256 and cfg.num_epochs == 4,
              "not the atari_params defaults")
        collect, train_fn, iteration = runner.sampler.collect_rollout, runner._train_fn, runner._train_iteration
        runner.train_state.optimizer.register_step_post_hook(end_of_first_epoch)

        def timed_collect(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj, ep = collect(*args, **kwargs)
            torch.cuda.synchronize()
            obs = traj["obs"]["obs"]
            rollouts.append({"ms": (time.perf_counter() - t0) * 1e3, "device": str(obs.device), "dtype": obs.dtype, "shape": tuple(obs.shape)})
            return traj, ep

        def timed_train(ts, traj, generator):
            step0 = ts.train_step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window["steps"] = 0
            out = train_fn(ts, traj, generator)
            torch.cuda.synchronize()
            calls.append({"ms": (time.perf_counter() - t0) * 1e3, "sgd_steps": ts.train_step - step0, "lr": ts.curr_lr,
                          "epochs": float(out["epochs_executed"]), "finite": all(bool(torch.isfinite(v).all()) for v in out.values())})
            return out

        def windowed_iteration():
            if len(rollouts) == 1:
                reset_slot_timers(runner.sampler)  # the per-slot host times of iterations 2 and 3
            if len(rollouts) == iters - 1:
                slots.update(slot_ms(runner.sampler), slots_timed=runner.sampler.slots_timed)
                window["prof"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                window["prof"].start()
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
            return iteration()

        runner.sampler.collect_rollout, runner._train_fn, runner._train_iteration = timed_collect, timed_train, windowed_iteration

    argv = QUIET_HOST + ["--env=envpool_atari_breakout", f"--num_workers={workers}", "--num_envs_per_worker=32", "--worker_num_splits=2",
                         f"--train_for_env_steps={iters * envs * rollout * 4}", "--experiment=atari"]  # env steps count frames (frameskip 4)
    with standins_on_path("envpool"):
        runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=atari.register_envpool_atari_components,
                                             parse=atari.parse_envpool_atari_args)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == len(calls) == len(rollouts) == len(window["ms"]) == iters, f"{len(per_iter)} iterations, {len(calls)} train calls")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the atari path: {counts}")
    check(all(r["device"] == "cuda:0" and r["dtype"] == torch.uint8 and r["shape"] == (rollout + 1, envs, 84, 84, 4) for r in rollouts),
          f"observations {rollouts[0]['device']} {rollouts[0]['dtype']} {rollouts[0]['shape']}")
    lrs = [runner.cfg.learning_rate] + [c["lr"] for c in calls]
    check(all(a > b for a, b in zip(lrs, lrs[1:])), f"the learning rate did not fall after each train call: {lrs}")
    check(all(c["finite"] for c in calls) and all(math.isfinite(v) for v in stats.values()), "non-finite losses")
    check(all(c["sgd_steps"] == c["epochs"] * epoch_steps for c in calls), f"sgd steps {[c['sgd_steps'] for c in calls]}")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    check(profile.get("device_us", 0) > 0 and profile["activities"] > 0, f"the profiler saw no device activity: {profile}")
    timed = per_iter[1:iters - 1]
    emit({"phase": "atari", "env": "envpool_atari_breakout (stand-in pool)", "workers": workers, "cpu_count": os.cpu_count(), "envs": envs,
          "splits": 2, "rollout": rollout, "iterations": iters, "env_steps_frames": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_iterations_2_3": envs * rollout * len(timed) / sum(timed), "rollout_ms": [r["ms"] for r in rollouts],
          "learner_ms": [c["ms"] for c in calls], "sgd_steps_per_iteration": [c["sgd_steps"] for c in calls], "lr": lrs,
          "upload_bytes_per_iteration": (rollout + 1) * envs * ATARI_FRAME_BYTES, "slot_ms_host_clock_iterations_2_3": slots,
          "window": f"the rollout and the first epoch ({epoch_steps} SGD steps), host clock, synced", "window_ms": window["ms"],
          "profiled_window_iteration_4": {"wall_ms": profile["wall_ms"], "profiler_stop_s": profile["stop_s"],
                                          "device_busy_ms": profile["device_us"] / 1e3, "device_activities": profile["activities"],
                                          "top_device_ms": profile["top"],
                                          "device_idle_share_vs_unprofiled_window_3": 1.0 - profile["device_us"] / (window["ms"][2] * 1e3)},
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "timing": runner.timing.flat_str(), "card": card})
    return counts


@contextlib.contextmanager
def launch_shapes(cuda_rnn):
    """Record (kind, T, B, H) of each kernel launch while the block runs; the wrappers count as before."""
    seen, launch = [], cuda_rnn._launch

    def recording(kind, x_proj, *args):
        seen.append((kind, x_proj.shape[0], x_proj.shape[1], x_proj.shape[2] // (3 if kind == "gru" else 4)))
        return launch(kind, x_proj, *args)

    cuda_rnn._launch = recording
    try:
        yield seen
    finally:
        cuda_rnn._launch = launch


def host_workers(paper_workers, envs, splits=2):
    """The paper's worker count where the machine has a core for each, else the most workers (one a
    core) that keep all `envs` in equal splits: the env count is never cut."""
    cores = os.cpu_count() or 1
    for w in range(min(paper_workers, cores), 0, -1):
        if envs % w == 0 and (envs // w) % splits == 0:
            return w
    raise RuntimeError(f"no worker count divides {envs} envs")


def instrument_host_iterations(torch, runner, iters, record):
    """Per iteration (host clock, synced): the iteration, its rollout (with the learner quanta the
    pacer dispatches inside it) and the host time in quanta and in the flush; the per-slot times
    count from iteration 2; the last iteration runs under the profiler (CUDA activity only)."""
    q, sampler, iteration = runner._quantizer, runner.sampler, runner._train_iteration
    collect, dispatch_one, flush = sampler.collect_rollout, q.dispatch_one, q.flush
    learner = {"quanta": 0.0, "flush": 0.0}

    def clocked(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            learner[key] += time.perf_counter() - t0
            return out
        return call

    def timed_collect(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect(*args, **kwargs)
        torch.cuda.synchronize()
        record["rollout_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_iteration():
        k = len(record["iteration_ms"])
        if k == 1:
            reset_slot_timers(sampler)
        if k == iters - 1:
            record["slot_ms"] = dict(slot_ms(sampler), slots_timed=sampler.slots_timed)  # iterations 2 to N-1, unprofiled
        learner.update(quanta=0.0, flush=0.0)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if k == iters - 1 else None
        if prof is not None:
            prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = iteration()
        torch.cuda.synchronize()
        record["iteration_ms"].append((time.perf_counter() - t0) * 1e3)
        record["learner_quanta_ms"].append(learner["quanta"] * 1e3)
        record["learner_flush_ms"].append(learner["flush"] * 1e3)
        if prof is not None:
            prof.stop()
            device_us, rnn_us, on_device, by_name = device_activities(torch, prof)
            unprofiled_ms = record["iteration_ms"][-2]
            record["profile"] = {"profiled_iteration_ms": record["iteration_ms"][-1], "device_busy_ms": device_us / 1e3,
                                 "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
                                 "device_idle_share_vs_unprofiled_iteration": 1.0 - device_us / (unprofiled_ms * 1e3),
                                 "top_device_ms": {k2: v / 1e3 for k2, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}}
        return out

    sampler.collect_rollout, runner._train_iteration = timed_collect, timed_iteration
    q.dispatch_one, q.flush = clocked("quanta", dispatch_one), clocked("flush", flush)


def host_example_line(runner, iters, record, envs):
    steady = record["iteration_ms"][1:]
    return {"iterations": iters, "env_steps_frames": runner.env_steps, "iteration_ms": record["iteration_ms"],
            "env_steps_per_s_iterations_2_on": envs * runner.cfg.rollout * len(steady) / (sum(steady) / 1e3),
            "rollout_ms": record["rollout_ms"], "learner_quanta_host_ms": record["learner_quanta_ms"],
            "learner_flush_host_ms": record["learner_flush_ms"], "slot_ms_host_clock_unprofiled_iterations_2_on": record["slot_ms"],
            "device_in_the_last_iteration": record["profile"],
            "stat": "host clock, synced; the rollout includes the learner quanta dispatched inside it; the last iteration "
                    "under torch.profiler (CUDA activity only), its busy time against the iteration before, unprofiled",
            "timing": runner.timing.flat_str()}


DOOM_ENVS, DOOM_PAPER_WORKERS, DOOM_ITERS = 400, 20, 4


def phase_doom(torch, cuda_rnn, card, tmp):
    """The paper's doom_battle command line (`sf_examples_tpu/vizdoom/experiments/doom_battle_appo.py`)
    through the port's `train_vizdoom` flags: doom_params, GRU-512 float32 (the cfg's defaults),
    convnet_simple over 72x128x3, the measurements MLP, the tuple head, 400 envs, batch 2048, async
    with the quantized learner; 4 iterations over the env-level stand-in of
    `tests/standins/doom_battle_standin.py` (the card's machine has neither gymnasium nor vizdoom)."""
    with restored_encoder_factory(), standins_on_path("doom_battle_standin"):
        return doom_run(torch, cuda_rnn, card, tmp)


def doom_run(torch, cuda_rnn, card, tmp):
    import doom_battle_standin as standin

    from sample_factory_tpu_torch.envs.spaces import TupleSpec
    from sample_factory_tpu_torch.examples.custom_encoders import VizdoomEncoder
    from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg

    workers = host_workers(DOOM_PAPER_WORKERS, DOOM_ENVS)
    cut = None if workers == DOOM_PAPER_WORKERS else f"{workers} workers x {DOOM_ENVS // workers} envs (paper: 20 x 20; {os.cpu_count()} cores)"
    if cut:
        print(f"doom: {cut}", flush=True)
    standin.register_doom_battle_standin()
    record = {"iteration_ms": [], "rollout_ms": [], "learner_quanta_ms": [], "learner_flush_ms": [], "slot_ms": {}, "profile": {}}

    def before_run(runner):
        cfg = runner.cfg
        check_host_example(runner, workers, VizdoomEncoder)
        check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.use_rnn, cfg.recurrence) == ("gru", 512, "float32", True, 32)
              and cfg.encoder_conv_architecture == "convnet_simple" and cfg.exploration_loss == "symmetric_kl" and cfg.normalize_input
              and cfg.normalize_returns and cfg.reward_scale == 0.5 and cfg.batch_size == 2048 and cfg.env_frameskip == 4
              and cfg.ppo_clip_value == 0.2, "not the paper's doom_battle configuration")
        check(runner.env_info.obs_space == standin.DoomBattleStandIn().observation_space
              and isinstance(runner.env_info.action_space, TupleSpec), f"spaces {runner.env_info.obs_space}")
        instrument_host_iterations(torch, runner, DOOM_ITERS, record)

    argv = QUIET_HOST + ["--env=doom_battle", "--env_frameskip=4", "--use_rnn=True", "--reward_scale=0.5", f"--num_workers={workers}",
                         f"--num_envs_per_worker={DOOM_ENVS // workers}", "--batch_size=2048", "--wide_aspect_ratio=False",
                         f"--train_for_env_steps={DOOM_ITERS * DOOM_ENVS * 32 * 4}", "--experiment=doom"]  # env steps count frames
    with launch_shapes(cuda_rnn) as shapes:
        runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=standin.register_doom_battle_standin,
                                         parse=parse_vizdoom_cfg)
    minibatches = runner._quantizer.num_minibatches
    check(len(record["iteration_ms"]) == DOOM_ITERS, f"{len(record['iteration_ms'])} iterations")
    check(minibatches == DOOM_ENVS * 32 // 2048 and counts["gru_seq_rows"] == DOOM_ITERS * minibatches,
          f"gru_seq_rows launches {counts['gru_seq_rows']}, expected {DOOM_ITERS} train steps x {minibatches} minibatches")
    check(all(v == 0 for k, v in counts.items() if k != "gru_seq_rows"), f"other kernels launched on the doom path: {counts}")
    check(set(shapes) == {("gru", *DOOM_GRU[:3])}, f"launch shapes {set(shapes)}")
    check(runner.episode_stats.avg_reward is not None, "no episode finished")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "doom", "env": "doom_battle (env-level stand-in)", "workers": workers, "envs": DOOM_ENVS, "cut": cut,
          "cpu_count": os.cpu_count(), "splits": runner.cfg.worker_num_splits, "rollout": 32, "batch": 2048, "model": "convnet_simple + "
          "measurements MLP, GRU-512 float32", "launches": counts, "launch_shapes": sorted(set(shapes)), "minibatches_per_train_step": minibatches,
          **host_example_line(runner, DOOM_ITERS, record, DOOM_ENVS), "avg_episode_reward": runner.episode_stats.avg_reward,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


DMLAB_ENVS, DMLAB_PAPER_WORKERS, DMLAB_ITERS = 128, 32, 4


def phase_dmlab(torch, cuda_rnn, card, tmp):
    """dmlab_30 at dmlab_params and the usage line of `docs/integrations/dmlab.md:20-21` (32 workers x
    4 envs, batch 1024): LSTM-256 over convnet_impala ++ the instruction encoder (embedding and
    LSTM-64 over 16 tokens), async with the quantized learner, 4 iterations. The envs are the port's
    own `DmlabEnv` (with its level cache in the run's directory, tokenization and reward clip) over the
    stand-in engine `tests/standins/deepmind_lab.py`; the DMLab-30 score tracker is registered as
    `train_dmlab.main` registers it."""
    with restored_encoder_factory(), standins_on_path("deepmind_lab"):
        return dmlab_run(torch, cuda_rnn, card, tmp)


def dmlab_run(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.examples.custom_encoders import DmlabEncoder
    from sample_factory_tpu_torch.examples.dmlab import train_dmlab
    from sample_factory_tpu_torch.examples.dmlab.dmlab_summaries import TARGET_OBJECTIVE_STAT, Dmlab30ScoreTracker

    workers = host_workers(DMLAB_PAPER_WORKERS, DMLAB_ENVS)
    cut = None if workers == DMLAB_PAPER_WORKERS else f"{workers} workers x {DMLAB_ENVS // workers} envs (usage line: 32 x 4; {os.cpu_count()} cores)"
    if cut:
        print(f"dmlab: {cut}", flush=True)
    train_dmlab.register_dmlab_components()
    record = {"iteration_ms": [], "rollout_ms": [], "learner_quanta_ms": [], "learner_flush_ms": [], "slot_ms": {}, "profile": {}}
    episodes = {}

    class CountingTracker(Dmlab30ScoreTracker):
        def on_episode_extra_stats(self, runner, extra_stats, policy_id):
            for key in extra_stats:
                if key.endswith("_dmlab_raw_score"):
                    level = key[len("z_00_"):-len("_dmlab_raw_score")]
                    episodes[level] = episodes.get(level, 0) + 1
            super().on_episode_extra_stats(runner, extra_stats, policy_id)

    tracker = {}

    def before_run(runner):
        cfg = runner.cfg
        check_host_example(runner, workers, DmlabEncoder)
        check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.rollout, cfg.recurrence, cfg.batch_size, cfg.num_epochs)
              == ("lstm", 256, "float32", 32, 32, 1024, 1) and cfg.encoder_conv_architecture == "convnet_impala"
              and cfg.normalize_input_keys == ["obs"], "not dmlab_params")
        check(set(runner.train_state.obs_rms) == {"obs"}, "the instruction tokens are normalized")
        tracker["t"] = CountingTracker(cfg)  # as train_dmlab.main registers it
        runner.register_episodic_stats_handler(tracker["t"].on_episode_extra_stats)
        runner.register_observer(tracker["t"])
        instrument_host_iterations(torch, runner, DMLAB_ITERS, record)

    argv = QUIET_HOST + ["--env=dmlab_30", f"--num_workers={workers}", f"--num_envs_per_worker={DMLAB_ENVS // workers}",
                         f"--dmlab_level_cache_path={tmp}/dmlab_cache", f"--train_for_env_steps={DMLAB_ITERS * DMLAB_ENVS * 32 * 4}",
                         "--experiment=dmlab"]  # env steps count frames (frameskip 4)
    with launch_shapes(cuda_rnn) as shapes:
        runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=train_dmlab.register_dmlab_components,
                                         parse=train_dmlab.parse_dmlab_args)
    cfg, minibatches = runner.cfg, runner._quantizer.num_minibatches
    split = DMLAB_ENVS // cfg.worker_num_splits
    # the core (learner minibatches); the instruction encoder in a rollout slot, in a learner minibatch,
    # and in the learner's value of each env's last observation (prepare, once a train step)
    sites = {"core": ("lstm", *DMLAB_CORE[:3]), "instruction_rollout": ("lstm", *DMLAB_INSTR_ROLLOUT[:3]),
             "instruction_learner": ("lstm", *DMLAB_INSTR_LEARNER[:3]), "instruction_learner_last_value": ("lstm", *DMLAB_INSTR_BOOTSTRAP[:3])}
    by_site = {site: shapes.count(shape) for site, shape in sites.items()}
    check(len(record["iteration_ms"]) == DMLAB_ITERS and minibatches == 4 and split == DMLAB_INSTR_ROLLOUT[1], f"{minibatches} minibatches")
    check(by_site["core"] == by_site["instruction_learner"] == DMLAB_ITERS * minibatches
          and by_site["instruction_learner_last_value"] == DMLAB_ITERS, f"learner launches by site {by_site}")
    check(by_site["instruction_rollout"] >= DMLAB_ITERS * cfg.rollout * cfg.worker_num_splits, f"rollout launches by site {by_site}")
    check(sum(by_site.values()) == len(shapes) == counts["lstm_seq"] and all(v == 0 for k, v in counts.items() if k != "lstm_seq"),
          f"launches {counts}, shapes {set(shapes)}")
    check(sum(episodes.values()) > 0 and not shm_segments(), f"episodes {episodes}, segments {shm_segments()}")
    cache = os.path.join(tmp, "dmlab_cache")
    emit({"phase": "dmlab", "env": "dmlab_30 (DmlabEnv over the stand-in engine)", "workers": workers, "envs": DMLAB_ENVS, "cut": cut,
          "cpu_count": os.cpu_count(), "splits": cfg.worker_num_splits, "rollout": 32, "batch": 1024,
          "model": "convnet_impala ++ instruction embedding + LSTM-64, LSTM-256 float32", "launches": counts,
          "lstm_seq_launches_by_site": by_site, "minibatches_per_train_step": minibatches,
          **host_example_line(runner, DMLAB_ITERS, record, DMLAB_ENVS), "episodes_by_task": episodes, "tasks_seen": len(episodes),
          "dmlab_target_objective": [list(d) for d in runner.policy_avg_stats.get(TARGET_OBJECTIVE_STAT, [])],
          "level_cache_maps": len(os.listdir(os.path.join(cache, "maps"))) if os.path.isdir(os.path.join(cache, "maps")) else 0,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


SAMPLER_STEPS = 200_000


def phase_sampler(torch, card, tmp):
    """`examples/sampler/use_simplified_sampling_api.generate_trajectories` on its fallback (no ALE
    here): the synthetic on-device env at train_synthetic's defaults, on the card."""
    from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI
    from sample_factory_tpu_torch.examples.sampler import use_simplified_sampling_api as sampler

    parse, register = sampler._components()
    check(register.__module__ == "sample_factory_tpu_torch.examples.train_synthetic", f"the sampler took {register.__module__}, not the fallback")
    register()
    cfg = parse(["--env=synthetic_vector_discrete", "--experiment=sampler", f"--train_dir={tmp}", "--device=gpu", "--seed=0"])
    shapes, collect = [], SyncSamplingAPI.get_trajectories_sync

    def recording_collect(self):
        traj = collect(self)
        shapes.append(({str(v.device) for k, v in traj.items() if k != "obs"}, tuple(traj["rewards"].shape)))
        return traj

    SyncSamplingAPI.get_trajectories_sync = recording_collect
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        check(sampler.generate_trajectories(cfg, register, SAMPLER_STEPS) == 0, "generate_trajectories failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        SyncSamplingAPI.get_trajectories_sync = collect
    per_call = cfg.num_envs * cfg.rollout
    check(all(devices == {"cuda:0"} and shape == (cfg.rollout, cfg.num_envs) for devices, shape in shapes), f"trajectories {shapes[:2]}")
    check(len(shapes) == -(-SAMPLER_STEPS // per_call), f"{len(shapes)} calls of {per_call} samples for {SAMPLER_STEPS}")
    emit({"phase": "sampler", "env": cfg.env, "envs": cfg.num_envs, "rollout": cfg.rollout, "calls": len(shapes), "samples_per_call": per_call,
          "env_steps": len(shapes) * per_call, "seconds": seconds, "env_steps_per_s": len(shapes) * per_call / seconds,
          "stat": "host clock around generate_trajectories (start, the calls, stop), synced", "card": card})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import register_synthetic_components
    from sample_factory_tpu_torch.native import shm_queue
    from sample_factory_tpu_torch.ops import cuda_rnn

    register_synthetic_components()
    register_bench_pixel()
    # full-precision float32 products for the comparisons (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    start = time.perf_counter()
    queue_path = shm_queue.build()  # g++; raises where it fails, so that the pipe transport cannot hide it
    lib_path = cuda_rnn.build()
    cuda_rnn.load_library()
    log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    # the launch plan assumes the cluster counts that run at once (cuda_rnn.MAX_CLUSTERS)
    at_once = {}
    cluster_shapes = [("gru_seq", "gru", MAIN_GRU), ("lstm_seq", "lstm", MAIN_LSTM), ("gru_seq_selfplay", "gru", SELFPLAY_GRU),
                      ("lstm_seq_dmlab_core", "lstm", DMLAB_CORE), ("lstm_seq_dmlab_instr_rollout", "lstm", DMLAB_INSTR_ROLLOUT),
                      ("lstm_seq_dmlab_instr_learner", "lstm", DMLAB_INSTR_LEARNER),
                      ("lstm_seq_dmlab_instr_last_value", "lstm", DMLAB_INSTR_BOOTSTRAP)]
    for name, kind, (T, B, H, dtype) in cluster_shapes:
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
        check(plan.design == "cluster", f"{name}: {(T, B, H, dtype)} does not take the cluster design")
        at_once[name] = {"shape": [T, B, H], "dtype": dtype, "clusters": plan.grid // plan.cluster,
                         "card_runs_at_once": cuda_rnn.max_active_clusters(kind, dtype, plan)}
        check(at_once[name]["card_runs_at_once"] >= 1, f"{name}: no cluster of {plan} fits the card")
    emit({"phase": "build", "seconds": time.perf_counter() - start, "library": lib_path.name, "shm_queue_library": queue_path.name,
          "ptxas": [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line],
          "clusters_at_main_shapes": at_once})

    main_err = phase_parity(torch, cuda_rnn)
    timing = phase_timing(torch, cuda_rnn, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = {}
        runner, paths["main"], sync_rate = phase_main(torch, cuda_rnn, card, tmp)
        phase_breakdown(torch, runner, card)
        paths["lstm"] = phase_lstm(torch, cuda_rnn, card, tmp)
        paths["appo"] = phase_appo(torch, cuda_rnn, card, tmp, runner, sync_rate)
        del runner
        paths["ant"] = phase_ant(torch, cuda_rnn, card, tmp)
        paths["towers"] = phase_towers(torch, cuda_rnn, card, tmp)
        paths["population"] = phase_population(torch, cuda_rnn, card, tmp)
        paths["selfplay"] = phase_selfplay(torch, cuda_rnn, card, tmp)
        phase_enjoy(torch, card, tmp)
        phase_export(torch, card, tmp)
        paths["host"] = phase_host(torch, cuda_rnn, card, tmp)
        paths["host_rnn"] = phase_host_rnn(torch, cuda_rnn, card, tmp)
        paths["host_selfplay"] = phase_host_selfplay(torch, cuda_rnn, card, tmp)
        phase_host_enjoy(torch, card, tmp)
        paths["custom_model"] = phase_custom_model(torch, cuda_rnn, card, tmp)
        paths["atari"] = phase_atari(torch, cuda_rnn, card, tmp)
        paths["doom"] = phase_doom(torch, cuda_rnn, card, tmp)
        paths["dmlab"] = phase_dmlab(torch, cuda_rnn, card, tmp)
        cuda_rnn.reset_launch_counts()
        phase_sampler(torch, card, tmp)
        check(all(v == 0 for v in cuda_rnn.launch_counts().values()), "an RNN kernel launched in the sampler phase")

    # launches: each path was driven with the counts at 0 just before it and read just after, and
    # each kernel's are counted by design (cluster: `*_seq`; rows: `*_seq_rows`); the kernel's numbers
    # are its cluster design's at the main-path shape, the row design's at its first path's shape
    def by_design(name, counts):
        return {"cluster": counts[name], "rows": counts[f"{name}_rows"]}

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": sum(sum(by_design(name, counts).values()) for counts in paths.values()),
         "launches_by_design": {d: sum(by_design(name, counts)[d] for counts in paths.values()) for d in ("cluster", "rows")},
         "paths": {path: by_design(name, counts) for path, counts in paths.items()},
         "max_abs_err": main_err[name], **timing[name], "library_ms": None,
         "row_design": {"max_abs_err": main_err[f"{name}_rows"], **timing[f"{name}_rows"]}}
        for name in ("gru_seq", "lstm_seq")
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
