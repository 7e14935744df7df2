#!/usr/bin/env python3
"""Benchmark suite of the PyTorch/CUDA port on one NVIDIA card: the counterpart of `bench.py`.

    python3 bench_gpu.py            # full depth
    python3 bench_gpu.py --smoke    # every scenario at a cut depth (SMOKE below)

Prints one JSON line per scenario ({"metric", "value", "unit", "vs_baseline", "device",
"power_limit_w", ...}); the LAST line is the headline, on-device PPO on the real-physics AntEnv
against the reference's strongest single-accelerator baseline (IsaacGym Ant, PhysX, 4096 env
agents, 204,651 FPS on 1 GPU: reference `sample_factory/benchmarking/benchmarking_isaacgym_ant.txt:1-30`),
with the whole suite under "suite".

Scenarios (each against its matching reference row, BASELINE.md), at bench.py's configurations:
  1. mlp_synthetic   physics-free env of IsaacGym-Ant widths: the framework+NN ceiling
  2. host_pixel      42x42x4 uint8 batched HOST env through the whole worker pipeline (shm slabs,
                     uint8 upload, quantized async learner), 2 x 32 envs, and 2 x 1024 envs (_gpu)
  3. grid_battle     24x24x3 pixel env, IMPALA conv + GRU-256, bf16: the ViZDoom-battle regime;
                     the BPTT recurrence runs in the hand-written `gru_seq` kernel
  4. ant_physics     AntEnv, real rigid-body quadruped dynamics, 4096 envs, the widths of #1
and the host-feeding decomposition (producer, upload, inference) and the 2-rank scaling proxy.

Every scenario that runs a model runs it on the card; the producer row runs none and is a host
number. A scenario's rate is the median of windows that each end in `torch.cuda.synchronize()`.
Efficiency accounting: model flops a sample from `torch.utils.flop_counter.FlopCounterMode`
(matmuls and convolutions), cross-checked against an analytic count of the same (2 x MACs of every
dense layer, convolution and RNN cell projection), and MFU against the card's dense bf16 peak,
matched by the card's name. Every row carries the card's name and power limit.

Exits 2 without a CUDA card, 1 when a scenario failed (its row carries "error"; the headline
still prints last), else 0. Imports nothing of JAX or of the JAX package. torch and the port are
imported inside the functions: the host scenarios' worker processes are spawned, and a spawned
process imports this script again, so that they load numpy and not torch.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

ISAAC_ANT_FPS = 204651.0  # IsaacGym Ant, 1 GPU (lower bound of the published range)
VIZDOOM_XEON_FPS = 137131.0  # ViZDoom battle, 36-core Xeon + GPUs
VIZDOOM_I9_FPS = 50000.0  # ViZDoom battle, 10-core i9

# dense bf16 tensor-core peak, matched by substring against torch.cuda.get_device_name
# (NVIDIA data sheets; the sparse figures halved). A name the table lacks gets no mfu.
GPU_PEAK_BF16 = [
    ("H100 80GB HBM3", 989e12),  # H100 SXM
    ("H100 NVL", 835.5e12),
    ("H100 PCIe", 756.5e12),
]

OBS_BYTES = 42 * 42 * 4  # one host-pixel frame stack, uint8
CHILD_TIMEOUT_S = 600


@dataclass(frozen=True)
class Depth:
    """How long each scenario measures."""

    warmup: int  # sync scenarios: iterations before the windows
    reps: int  # windows
    window: Optional[int]  # iterations a window; None: calibrated to about 1.5 s (_measure_fps_windows)
    profiled: int  # grid battle: iterations under torch.profiler
    host_iters: Optional[int] = None  # host pipelines: iterations and warm-up, None: each scenario's own
    host_warmup: Optional[int] = None


FULL = Depth(warmup=3, reps=5, window=None, profiled=10)
SMOKE = Depth(warmup=2, reps=1, window=10, profiled=2, host_iters=6, host_warmup=2)


@dataclass(frozen=True)
class Card:
    name: str  # torch.cuda.get_device_name, or "cpu"
    power_limit_w: Optional[float]  # nvidia-smi's power.limit

    def __str__(self) -> str:
        return self.name if self.power_limit_w is None else f"{self.name} at a {self.power_limit_w:g} W limit"


@dataclass(frozen=True)
class Bench:
    """What every scenario gets: the device it runs on, its depth and the card it names.
    `overrides` is appended to a scenario's argv (tests cut the sizes with it)."""

    device: torch.device
    depth: Depth
    card: Card
    overrides: Tuple[str, ...] = ()


def read_card(device: torch.device) -> Card:
    import torch

    if device.type != "cuda":
        return Card("cpu", None)
    from sample_factory_tpu_torch.utils.device_profile import card_line, power_limit_w

    return Card(torch.cuda.get_device_name(device), power_limit_w(card_line()))


def _card_fields(card: Card) -> dict:
    return {"device": card.name, "power_limit_w": card.power_limit_w}


def _sync(device: torch.device) -> Callable[[], None]:
    import torch

    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def _device_argv(b: Bench) -> list:
    """The port's own --device flag: the card is its default."""
    return ["--device=cpu"] if b.device.type == "cpu" else []


def _device_peak_bf16(name: str):
    for tag, peak in GPU_PEAK_BF16:
        if tag in name:
            return peak
    return None


def _fwd_flops_per_sample(model, example_obs, rnn_state, batch: int = 1024):
    """Model forward flops a sample: one step-mode forward at `batch` under FlopCounterMode, on a
    copy of the model on the meta device: the counts depend on the shapes alone, so nothing is
    computed, as bench.py compiles without running. FlopCounterMode counts matmuls and
    convolutions, not elementwise work."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta_model = copy.deepcopy(model).to("meta")
    obs = {k: torch.zeros((batch,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta") for k, v in example_obs.items()}
    rnn = torch.zeros((batch,) + tuple(rnn_state.shape[1:]), dtype=rnn_state.dtype, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        meta_model(obs, rnn)
    return counter.get_total_flops() / batch


def _analytic_fwd_flops(model, example_obs, rnn_state):
    """Independent cross-check of the counted flops: 2*MACs of every dense layer (a 2-D weight),
    every convolution (a 4-D weight; its output H x W from forward hooks on one sample) and the
    RNN cells' `wi` and `wh`. Elementwise and normalization work is excluded."""
    import torch
    from torch import nn

    from sample_factory_tpu_torch.models.model_utils import Conv, Dense
    from sample_factory_tpu_torch.ops.rnn_cells import FusedGRUCell, FusedLSTMCell

    device = next(model.parameters()).device
    out_hw = {}
    convs = {name: m for name, m in model.named_modules() if isinstance(m, (Conv, nn.Conv2d))}
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: out_hw.__setitem__(name, tuple(out.shape[-2:])))
             for name, m in convs.items()]
    try:
        with torch.no_grad():
            model({k: v[:1].to(device) for k, v in example_obs.items()}, rnn_state[:1].to(device))
    finally:
        for h in hooks:
            h.remove()
    flops = 0.0
    for name, m in model.named_modules():
        if isinstance(m, (Dense, nn.Linear)):
            flops += 2.0 * m.weight.numel()
        elif name in convs:
            oh, ow = out_hw[name]
            flops += 2.0 * m.weight.numel() * oh * ow
        elif isinstance(m, (FusedGRUCell, FusedLSTMCell)):
            flops += 2.0 * (m.wi.numel() + m.wh.numel())
    return flops


def _flops_fields(model, example_obs, rnn_state, batch: int = 1024):
    """Counted flops + analytic cross-check + agreement ratio."""
    counted = _fwd_flops_per_sample(model, example_obs, rnn_state, batch=batch)
    analytic = _analytic_fwd_flops(model, example_obs, rnn_state)
    fields = {"fwd_flops_per_sample": round(counted), "fwd_flops_analytic": round(analytic)}
    if analytic > 0:
        ratio = counted / analytic
        fields["flops_xcheck_ratio"] = round(ratio, 3)
        # both count the same matmuls and convolutions, so the ratio sits at 1.0; bench.py's
        # band [0.9, 1.5] is kept: outside it one of the counters is untrustworthy
        if not (0.9 <= ratio <= 1.5):
            fields["flops_xcheck_violation"] = True
            print(f"WARNING: flop counters disagree (counted={counted:.3e}, analytic={analytic:.3e})", file=sys.stderr, flush=True)
    return counted, fields


def _mfu_fields(fwd_flops_per_sample, fps, rollout: int, num_epochs: int, card: Card):
    """MODEL-flops MFU: rollout inference (1 fwd/step) + the bootstrap value pass (1/rollout) +
    training (fwd + backward ~= 2x fwd, per epoch, every sample trains once per epoch). Env
    dynamics, GAE and optimizer flops are excluded (the standard model-flops convention). The
    denominator is the card's dense bf16 peak; float32 scenarios face a lower realistic ceiling.

    mfu >= 1 is physically impossible: the row is then flagged (mfu_violation) and a warning
    goes to stderr: the FPS measurement or the flop count is wrong."""
    peak = _device_peak_bf16(card.name)
    flops_per_env_step = fwd_flops_per_sample * (1.0 + 1.0 / rollout + 3.0 * num_epochs)
    tflops = fps * flops_per_env_step / 1e12
    out = {"model_flops_per_env_step": round(flops_per_env_step), "tflops": round(tflops, 3), **_card_fields(card)}
    if peak is not None:
        mfu = tflops * 1e12 / peak
        out["mfu"] = round(mfu, 5)
        out["mfu_peak_tflops_bf16"] = peak / 1e12
        if mfu >= 1.0:
            out["mfu_violation"] = True
            print(f"WARNING: impossible MFU {mfu:.3f} (>100% of {peak / 1e12:.0f} TFLOP/s bf16 peak): FPS measurement or "
                  "flop count is wrong; do not trust this row", file=sys.stderr, flush=True)
    return out


def _measure_fps_windows(step_once, steps_per_iter: int, *, sync: Callable[[], None], reps: int = 5,
                         target_window_s: float = 1.5, window: Optional[int] = None):
    """Steady-state throughput: `reps` windows of W iterations, each ending in `sync()`, so
    that a window's time holds all of its device work. W is calibrated from 10 iterations to
    about `target_window_s` (clamped to [10, 1200]) unless `window` gives it. The value is
    the median window; fps_best the fastest, fps_spread_pct the range over the median.

    step_once() enqueues one iteration."""
    if window is None:
        t0 = time.perf_counter()
        for _ in range(10):
            step_once()
        sync()
        per_iter = max((time.perf_counter() - t0) / 10.0, 1e-6)
        W = int(min(1200, max(10, target_window_s / per_iter)))
    else:
        W = window

    fps_reps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(W):
            step_once()
        sync()
        fps_reps.append(W * steps_per_iter / (time.perf_counter() - t0))

    fps_sorted = sorted(fps_reps)
    fps = fps_sorted[len(fps_sorted) // 2]
    spread_pct = 100.0 * (fps_sorted[-1] - fps_sorted[0]) / max(fps, 1e-9)
    return fps, {
        "fps_windows": [round(f, 1) for f in fps_reps],
        "fps_best": round(fps_sorted[-1], 1),
        "fps_spread_pct": round(spread_pct, 2),
        "window_iters": W,
    }


DEVICE_TRACE_KEYS = ("profiled_iterations", "device_busy_ms_per_iteration", "device_idle_share_profiled",
                     "device_idle_share_unprofiled", "rnn_kernel_ms_per_iteration", "top_device_ms_per_iteration")


def _device_trace(b: Bench, step_once, unprofiled_iteration_s: float) -> dict:
    """`b.depth.profiled` steady iterations under torch.profiler, recording the card's activity
    alone: its busy time an iteration, its idle share against the profiled wall time and against
    an unprofiled iteration (the median window's), and the top device ops by name. The profiler
    reads the card only: on the CPU every value is None (not measured)."""
    if b.device.type != "cuda":
        return dict.fromkeys(DEVICE_TRACE_KEYS)
    from sample_factory_tpu_torch.utils.device_profile import profiled_device_time

    n = b.depth.profiled
    wall_us, busy_us, rnn_us, _, by_name = profiled_device_time(lambda: [step_once() for _ in range(n)])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "profiled_iterations": n,
        "device_busy_ms_per_iteration": busy_us / n / 1e3,
        "device_idle_share_profiled": 1.0 - busy_us / wall_us,
        "device_idle_share_unprofiled": 1.0 - busy_us / n / (unprofiled_iteration_s * 1e6),
        "rnn_kernel_ms_per_iteration": rnn_us / n / 1e3,
        "top_device_ms_per_iteration": {k: v / n / 1e3 for k, v in top},
    }


def _run_scenario(b: Bench, cfg, env, num_envs: int, seed: int = 0, trace: bool = False):
    """Build the sync rollout and train loop for (cfg, env) on `b.device`, as the runner's
    sync iteration does, and measure steady-state env-steps/s (_measure_fps_windows). With
    `trace`, `b.depth.profiled` more iterations under torch.profiler (_device_trace). The
    RNN kernels' launches are counted over every measured iteration."""
    import torch
    from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
    from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
    from sample_factory_tpu_torch.envs.env_info import extract_env_info
    from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
    from sample_factory_tpu_torch.ops import cuda_rnn

    device, sync = b.device, _sync(b.device)
    env_info = extract_env_info(env, cfg)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(seed))
    model.to(device)
    ts = init_train_state(cfg, env_info, model, device)
    ss = init_sampler_state(cfg, env, num_envs, device, torch.Generator(device).manual_seed(seed + 1))
    train_generator = torch.Generator(device).manual_seed(seed + 2)
    rollout_fn = make_rollout_fn(cfg, env, env_info)
    train_fn = make_train_fn(cfg, env_info, 0)

    fwd_flops, flops_fields = _flops_fields(model, {k: v[:2] for k, v in ss.obs.items()}, ss.rnn_state[:2], batch=1024)

    def train_iteration():
        _, traj, _ = rollout_fn(ts.model, ts.obs_rms, ss, ts.train_step, 0)  # updates ss in place
        train_fn(ts, traj, train_generator)

    for _ in range(b.depth.warmup):  # warm-up; the first launch of a kernel builds it
        train_iteration()
    sync()

    iterations = 0

    def step_once():
        nonlocal iterations
        iterations += 1
        train_iteration()

    steps_per_iter = num_envs * cfg.rollout
    cuda_rnn.reset_launch_counts()
    fps, window_fields = _measure_fps_windows(step_once, steps_per_iter, reps=b.depth.reps, sync=sync, window=b.depth.window)
    if trace:
        window_fields.update(_device_trace(b, step_once, steps_per_iter / fps))
    sync()
    launches = cuda_rnn.launch_counts()
    fields = {**_mfu_fields(fwd_flops, fps, cfg.rollout, cfg.num_epochs, b.card), **flops_fields, **window_fields,
              "iterations_counted": iterations, "rnn_kernel_launches": launches}
    return fps, fields


def _bench_mlp_env():
    """IsaacGym-Ant widths (obs 60, act 8), no physics: `SyntheticContinuousEnv` with 60 uniform
    draws an observation."""
    from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticContinuousEnv
    from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec

    class BenchEnv(SyntheticContinuousEnv):
        obs_shape = (60,)

        def __init__(self):
            super().__init__(dim=8, episode_len=1000)
            self.obs_space = make_dict_spec({"obs": Box((60,), 0.0, 1.0)})

    return BenchEnv()


def bench_mlp_synthetic(b: Bench):
    from sample_factory_tpu_torch.cfg.arguments import default_cfg

    num_envs = 4096
    cfg = default_cfg(
        env="bench_mlp",
        argv=[
            "--use_rnn=False",
            "--encoder_mlp_layers", "256", "128", "64",
            "--rollout=16",
            "--recurrence=1",
            "--batch_size=32768",
            "--num_epochs=2",
            f"--num_envs={num_envs}",
            "--num_workers=1",
            "--async_rl=False",
            "--normalize_input=True",
            "--normalize_returns=True",
            "--kl_loss_coeff=0.1",
            "--seed=0",
        ] + list(b.overrides),
    )
    fps, fields = _run_scenario(b, cfg, _bench_mlp_env(), cfg.num_envs)
    return fps, cfg.num_envs, fields


def bench_ant_physics(b: Bench):
    from sample_factory_tpu_torch.cfg.arguments import default_cfg
    from sample_factory_tpu_torch.envs.builtin.ant import AntEnv

    num_envs = 4096
    cfg = default_cfg(
        env="bench_ant",
        argv=[
            "--use_rnn=False",
            "--encoder_mlp_layers", "256", "128", "64",
            "--rollout=16",
            "--recurrence=1",
            "--batch_size=32768",
            "--num_epochs=4",
            f"--num_envs={num_envs}",
            "--num_workers=1",
            "--async_rl=False",
            "--normalize_input=True",
            "--normalize_returns=True",
            "--seed=0",
        ] + list(b.overrides),
    )
    fps, fields = _run_scenario(b, cfg, AntEnv(), cfg.num_envs)
    return fps, cfg.num_envs, fields


def bench_grid_battle(b: Bench):
    """The slice's kernel path: the learner's BPTT recurrence launches `gru_seq` once a
    minibatch. On the card a run that launched it otherwise (or another design) is an error."""
    from sample_factory_tpu_torch.cfg.arguments import default_cfg
    from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv

    num_envs = 1024
    cfg = default_cfg(
        env="bench_gb",
        argv=[
            "--use_rnn=True",
            "--rnn_type=gru",
            "--rnn_size=256",
            "--encoder_conv_architecture=convnet_impala",
            "--encoder_conv_mlp_layers", "256",
            "--compute_dtype=bfloat16",
            "--rollout=32",
            "--recurrence=32",
            "--batch_size=16384",
            "--num_epochs=1",
            f"--num_envs={num_envs}",
            "--num_workers=1",
            "--async_rl=False",
            "--normalize_input=True",
            "--seed=0",
        ] + list(b.overrides),
    )
    fps, fields = _run_scenario(b, cfg, GridBattleEnv(), cfg.num_envs, trace=True)
    minibatches = cfg.num_envs * cfg.rollout // cfg.batch_size * cfg.num_epochs
    launches = fields["rnn_kernel_launches"]
    fields["gru_seq_launches_per_iteration"] = launches["gru_seq"] / fields["iterations_counted"]
    if b.device.type == "cuda":
        want = {name: fields["iterations_counted"] * minibatches if name in ("gru_seq", "gru_seq_cluster_bwd") else 0 for name in launches}
        if launches != want:
            raise RuntimeError(f"RNN kernel launches {launches}, expected {want}: gru_seq (cluster design) and its backward "
                               "gru_seq_cluster_bwd once a minibatch")
    return fps, cfg.num_envs, fields


_HOST_PIXEL_BASE_ARGV = [
    "--env=bench_host_pixel",
    "--restart_behavior=overwrite",
    "--worker_num_splits=2",
    "--rollout=32",
    "--num_epochs=1",
    "--async_rl=True",
    "--use_rnn=False",
    "--encoder_conv_architecture=convnet_simple",
    "--encoder_conv_mlp_layers", "128",
    "--normalize_input=True",
    "--train_for_env_steps=999999999",
    "--seed=0",
    "--experiment_summaries_interval=10000",
    "--save_every_sec=10000",
    "--decorrelate_envs_on_one_worker=False",
]


def _check_transport(sampler) -> None:
    if sampler.transport != "shm_queue":
        raise RuntimeError(f"host sampler transport {sampler.transport}: the shared-memory queue did not build")


def _host_pixel_measure(b: Bench, extra_argv, n_iters: int = 40, warmup: int = 8):
    """Run the whole host pipeline (worker processes + shm slabs + uint8 upload + quantized
    async learner) through HostEnvRunner and measure steady-state env-steps/s, each iteration's
    mark taken after a sync, with 8-iteration sub-windows for the spread. The run writes under a
    temporary train_dir."""
    import torch
    from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    if b.depth.host_iters is not None:
        n_iters, warmup = b.depth.host_iters, b.depth.host_warmup
    sync = _sync(b.device)
    marks = []

    class Timer(AlgoObserver):
        def on_training_iteration(self, runner, stats) -> None:
            sync()
            marks.append((time.perf_counter(), runner.env_steps))
            if len(marks) >= n_iters:
                runner.stop()

    with tempfile.TemporaryDirectory(prefix="sf_bench_") as train_dir:
        argv = _HOST_PIXEL_BASE_ARGV + list(extra_argv) + _device_argv(b) + [f"--train_dir={train_dir}"] + list(b.overrides)
        parser, _ = parse_sf_args(argv=argv)
        cfg = parse_full_cfg(parser, argv=argv)
        register_bench_pixel()
        runner = HostEnvRunner(cfg, register_fn=register_bench_pixel)
        runner.init()
        try:
            runner.register_observer(Timer())
            _check_transport(runner.sampler)
            # flops probe BEFORE run(): the sampler's shm slabs are torn down after
            slab = runner.sampler.slabs.arrays
            example_obs = {k: torch.from_numpy(slab[f"obs_{k}"][0, 0, :2].copy()) for k in runner.sampler.obs_keys}
            fwd_flops, flops_fields = _flops_fields(runner.model, example_obs, runner.sampler.rnn_states[0][:2], batch=256)
            transport = runner.sampler.transport
            if runner.run() != 0:
                raise RuntimeError("runner.run() failed")
        finally:
            runner.sampler.close()
    warm = marks[warmup:]
    fps = (warm[-1][1] - warm[0][1]) / (warm[-1][0] - warm[0][0])
    sub = []
    for i in range(0, len(warm) - 8, 8):
        lo, hi = warm[i], warm[i + 8]
        sub.append(round((hi[1] - lo[1]) / max(hi[0] - lo[0], 1e-9), 1))
    spread = 100.0 * (max(sub) - min(sub)) / max(fps, 1e-9) if sub else None
    return {
        "host_pixel_fps": round(fps, 1),
        "fwd_flops_per_sample": fwd_flops,
        "fps_windows": sub,
        "fps_spread_pct": round(spread, 2) if spread is not None else None,
        "iterations": len(marks),
        "warmup_iterations": warmup,
        "transport": transport,
        **flops_fields,
    }


def bench_host_pixel(b: Bench):
    """The small composition (bench.py's CPU-backend child): 2 workers x 32 envs, batch 1024,
    with inference and the learner on the card."""
    return _host_pixel_measure(
        b,
        [
            "--experiment=bench_host_pixel",
            "--num_workers=2",
            "--num_envs_per_worker=32",
            "--batch_size=1024",
        ],
    )


def _upload_probe(b: Bench, n: int = 10) -> dict:
    """A split (1024 x 42x42x4 uint8) uploaded n times, each ended by a synchronize: from pageable
    memory (`torch.from_numpy(x).to(device)`) and through a pinned staging copy, as the host
    sampler uploads (algo/host_sampling.py: `_staging`, `_upload_obs`)."""
    import torch

    split = np.random.default_rng(0).integers(0, 255, (1024, 42, 42, 4), np.uint8)
    stage = torch.empty(split.shape, dtype=torch.uint8).pin_memory()
    dst = torch.empty(split.shape, dtype=torch.uint8, device=b.device)

    def pageable():
        torch.from_numpy(split).to(b.device)

    def pinned():
        np.copyto(stage.numpy(), split)
        dst.copy_(stage, non_blocking=True)

    rates = {}
    for name, upload in (("pageable", pageable), ("pinned", pinned)):
        upload()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            upload()
            torch.cuda.synchronize()
        rates[name] = n * split.nbytes / (time.perf_counter() - t0)
    return {
        "upload_bandwidth_mb_s": round(rates["pinned"] / 1e6, 1),
        "upload_bandwidth_pageable_mb_s": round(rates["pageable"] / 1e6, 1),
        "upload_bound_ceiling_steps_s": round(rates["pinned"] / OBS_BYTES, 1),
    }


def bench_host_pixel_gpu(b: Bench):
    """The card-fed composition (bench.py's `_tpu` row): 2 CPU worker processes x 1024 envs feed
    the card, which runs inference and the quantized async learner; large splits amortize the
    per-step action fetch. The row carries an upload probe and the ceiling it sets."""
    rec = _host_pixel_measure(
        b,
        [
            "--experiment=bench_host_pixel_gpu",
            "--num_workers=2",
            "--num_envs_per_worker=1024",
            "--batch_size=8192",
        ],
        n_iters=16,
        warmup=4,
    )
    rec.update(_upload_probe(b))
    return rec


def bench_producer(b: Bench):
    """Host-feeding decomposition, stage 1: the worker -> shm-slab PRODUCER rate. The host
    sampler's worker machinery with no policy, no upload and no learner: constant actions go
    into the action slab and the step/ready handshake runs as fast as the workers fill the
    observation slabs. No model runs, so this is a host number."""
    import torch
    from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
    from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.envs.env_info import obtain_env_info

    with tempfile.TemporaryDirectory(prefix="sf_bench_") as train_dir:
        argv = [
            "--env=bench_host_pixel",
            "--experiment=bench_producer",
            "--restart_behavior=overwrite",
            "--device=cpu",
            "--num_workers=2",
            "--num_envs_per_worker=32",
            "--worker_num_splits=2",
            "--rollout=32",
            "--use_rnn=False",
            "--encoder_conv_architecture=convnet_simple",
            "--seed=0",
            "--decorrelate_envs_on_one_worker=False",
            f"--train_dir={train_dir}",
        ]
        parser, _ = parse_sf_args(argv=argv)
        cfg = parse_full_cfg(parser, argv=argv)
        register_bench_pixel()
        env_info = obtain_env_info(cfg, register_fn=register_bench_pixel)
        sampler = HostVectorSampler(cfg, env_info, torch.device("cpu"), register_fn=register_bench_pixel)
        try:
            sampler.start()
            _check_transport(sampler)
            signaled = [False] * sampler.K

            def step_all(n: int) -> None:
                for _t in range(n):
                    for s in range(sampler.K):
                        if signaled[s]:
                            sampler._wait_ready(s)
                        sampler.slabs.arrays["actions"][:, s] = 0
                        sampler._signal_step(s)
                        signaled[s] = True

            step_all(64)  # warm-up (the workers built their envs in start())
            n = 512
            t0 = time.perf_counter()
            step_all(n)
            for s in range(sampler.K):
                sampler._wait_ready(s)
                signaled[s] = False
            elapsed = time.perf_counter() - t0
            return n * sampler.num_envs / elapsed
        finally:
            sampler.close()


def bench_device_transfer(b: Bench):
    """Host-feeding decomposition, stage 2: host -> card obs upload from pageable memory.
    (a) split-sized transfers (64 x 42x42x4 uint8): per-call latency dominates;
    (b) bulk 64 MB transfers: the link bandwidth pipelining can reach.
    Each series ends in a synchronize."""
    import torch

    dev, sync = b.device, _sync(b.device)
    split = np.random.default_rng(0).integers(0, 255, (64, 42, 42, 4), np.uint8)
    for _ in range(3):
        torch.from_numpy(split).to(dev)
    sync()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        torch.from_numpy(split).to(dev)
    sync()
    split_obs_rate = n * split.shape[0] / (time.perf_counter() - t0)

    big = np.random.default_rng(1).integers(0, 255, (64 << 20,), np.uint8)
    torch.from_numpy(big).to(dev)
    sync()
    m = 3
    t0 = time.perf_counter()
    for _ in range(m):
        torch.from_numpy(big).to(dev)
    sync()
    bulk_gbps = m * big.nbytes / (time.perf_counter() - t0) / 1e9
    return split_obs_rate, bulk_gbps


def bench_pixel_inference_only(b: Bench):
    """Host-feeding decomposition, stage 3: inference rate for the host-pixel model with the
    uint8 obs already on the card (an upper bound on the pipeline's inference stage), at the
    pipeline's split size 64 (per-call latency visible) and at batch 4096 (compute ceiling)."""
    import torch
    from sample_factory_tpu_torch.cfg.arguments import default_cfg
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.envs.env_info import obtain_env_info
    from sample_factory_tpu_torch.models.actor_critic import create_actor_critic, initial_actor_critic_state

    dev, sync = b.device, _sync(b.device)
    cfg = default_cfg(
        env="bench_host_pixel",
        argv=[
            "--use_rnn=False",
            "--encoder_conv_architecture=convnet_simple",
            "--encoder_conv_mlp_layers", "128",
            "--normalize_input=True",
            "--seed=0",
        ],
    )
    register_bench_pixel()
    env_info = obtain_env_info(cfg, register_fn=register_bench_pixel)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(0)).to(dev)

    rates = {}
    for batch in (64, 4096):
        obs = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (batch, 42, 42, 4), np.uint8)).to(dev)
        rnn = initial_actor_critic_state(cfg, batch, dev)

        @torch.no_grad()
        def fwd():
            return model({"obs": obs.float() / 255.0}, rnn)

        fwd()
        sync()
        t0 = time.perf_counter()
        n = 100
        for _ in range(n):
            fwd()
        sync()
        rates[batch] = n * batch / (time.perf_counter() - t0)
    return rates


class ComputeEnv:
    """~100 us of real numpy work a step: the env-bound host regime. Its spaces are the port's
    own specs (the observation a dict spec, as the host wrappers take it without gymnasium),
    so it runs where gymnasium is not installed."""

    gymnasium_api = True

    def __init__(self):
        from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec

        self.observation_space = make_dict_spec({"obs": Box((32,), -10.0, 10.0, "float32")})
        self.action_space = Discrete(4)
        self.rng = np.random.default_rng(0)
        self.state = self.rng.normal(size=(64, 32)).astype(np.float32)
        self.t = 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t = 0
        return {"obs": self.state[0]}, {}

    def step(self, a):
        self.t += 1
        self.state = np.tanh(self.state @ self.state.T[:, :32] * 0.01)
        return {"obs": self.state[0]}, float(a), self.t >= 64, False, {}

    def close(self):
        pass


def register_compute_env() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env("bench_compute_env", lambda name, cfg=None, env_config=None, render_mode=None: ComputeEnv())


def _scaling_child(port: int, pid: int, nproc: int, core: int, train_dir: str, depth: Depth) -> int:
    """One process of the scaling proxy. Pinned to ONE core so that 1-process and 2-process runs
    get the same resources a process: the ratio then measures the COORDINATION cost (the
    learner's all-reduces and the iteration's lockstep), not core scarcity. With nproc > 1 it
    joins a gloo group on cuda:0, as a launcher's environment describes it."""
    import torch

    try:
        os.sched_setaffinity(0, {core})
    except (AttributeError, OSError):
        pass
    torch.set_num_threads(1)
    from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    if nproc > 1:
        multihost.init_distributed(backend="gloo")

    # production-shaped iterations (~0.5 s of real work): weak scaling with tiny iterations
    # would only measure the fixed per-iteration lockstep skew of the two processes
    argv = [
        "--env=bench_compute_env",
        f"--experiment=bench_scaling_p{nproc}",
        "--restart_behavior=overwrite",
        "--serial_mode=True",
        "--num_workers=2",
        "--num_envs_per_worker=32",
        "--worker_num_splits=2",
        "--rollout=32",
        "--batch_size=1024",
        "--num_epochs=1",
        "--use_rnn=False",
        "--encoder_mlp_layers", "128", "128",
        "--train_for_env_steps=999999999",
        "--async_rl=False",
        "--seed=7",
        "--experiment_summaries_interval=10000",
        "--save_every_sec=10000",
        "--decorrelate_envs_on_one_worker=False",
        f"--train_dir={train_dir}",
    ] + (["--jax_distributed=True"] if nproc > 1 else [])
    parser, _ = parse_sf_args(argv=argv)
    cfg = parse_full_cfg(parser, argv=argv)
    register_compute_env()

    n_iters, warmup = (depth.host_iters, depth.host_warmup) if depth.host_iters is not None else (20, 6)
    marks = []

    class Timer(AlgoObserver):
        def on_training_iteration(self, runner, stats) -> None:
            _sync(runner.device)()
            marks.append((time.perf_counter(), runner.env_steps))
            if len(marks) >= n_iters:
                runner.stop()

    runner = HostEnvRunner(cfg, register_fn=register_compute_env)
    runner.init()
    runner.register_observer(Timer())
    if runner.run() != 0:
        raise RuntimeError("runner.run() failed")
    warm = marks[warmup:]
    fps = (warm[-1][1] - warm[0][1]) / (warm[-1][0] - warm[0][0])  # env_steps counts every rank's
    print(json.dumps({"scaling_fps": round(fps, 1), "pid": pid, "nproc": nproc}), flush=True)
    multihost.shutdown()
    return 0


def bench_scaling_proxy(b: Bench):
    """Weak-scaling proxy on this host (BASELINE.md north star: >= 80% scaling efficiency): two
    gloo ranks of the host-env pipeline against a single process, each process pinned to one core
    and running its model on cuda:0. Each rank runs its own envs and the learner reduces over
    both, so ideal weak scaling doubles the global throughput."""

    def run(nproc):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        depth_flag = ["--smoke"] if b.depth == SMOKE else []
        with tempfile.TemporaryDirectory(prefix="sf_bench_") as train_dir:
            procs = []
            try:
                for i in range(nproc):
                    env = dict(os.environ)
                    if nproc > 1:
                        env.update(RANK=str(i), WORLD_SIZE=str(nproc), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                    cmd = [sys.executable, os.path.abspath(__file__), "--scaling-child", str(port), str(i), str(nproc), str(i),
                           train_dir, *depth_flag]
                    procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
                outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        fps = None
        for out, p in zip(outs, procs):
            if p.returncode != 0:
                raise RuntimeError(f"scaling child failed:\n{out[-2000:]}")
            for line in reversed(out.splitlines()):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("pid") == 0:
                    fps = rec["scaling_fps"]
                    break
        if fps is None:
            raise RuntimeError(f"no scaling result:\n{outs[0][-2000:]}")
        return fps

    fps1 = run(1)
    fps2 = run(2)
    return fps1, fps2, fps2 / (2.0 * fps1)


# ---------------------------------------------------------------------------------- rows


def s_mlp(b: Bench) -> dict:
    fps, n, fields = bench_mlp_synthetic(b)
    return {
        "value": round(fps, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(fps / ISAAC_ANT_FPS, 3),
        **fields,
        "note": f"{n} physics-FREE envs, IsaacGym-Ant widths, on {b.card}; framework+NN overhead ceiling, not a "
        "physics comparison (that is ant_physics_sync_ppo); f32 model, so the realistic ceiling is below the quoted "
        "bf16 peak",
    }


def _host_row(rec: dict, b: Bench, keys) -> dict:
    fps = rec["host_pixel_fps"]
    return {
        "value": fps,
        "unit": "env_steps/s",
        "vs_baseline": round(fps / VIZDOOM_I9_FPS, 3),
        **_mfu_fields(rec["fwd_flops_per_sample"], fps, rollout=32, num_epochs=1, card=b.card),
        **{k: rec[k] for k in keys if rec.get(k) is not None},
    }


HOST_KEYS = ("fps_windows", "fps_spread_pct", "fwd_flops_analytic", "flops_xcheck_ratio", "flops_xcheck_violation",
             "iterations", "warmup_iterations", "transport")


def s_host_pixel(b: Bench) -> dict:
    return {
        **_host_row(bench_host_pixel(b), b, HOST_KEYS),
        "note": f"42x42x4 uint8 synthetic batched host env (envpool-style, zero env cost), 2 worker procs x 32 envs, "
        f"inference and the quantized async learner on {b.card}; vs ViZDoom battle 50K FPS on a 10-core i9 "
        "(feeding-machinery proxy, no real game engine); see the host_pipeline_* rows for its stages",
    }


def s_producer(b: Bench) -> dict:
    producer_fps = bench_producer(b)
    return {
        "value": round(producer_fps, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(producer_fps / VIZDOOM_I9_FPS, 3),
        "note": "stage 1 of host_pixel_pipeline_appo: worker procs filling shm obs slabs with constant actions, no "
        f"inference, upload or training: a HOST number (no model runs) on the host of {b.card}",
    }


def s_transfer(b: Bench) -> dict:
    split_obs_rate, bulk_gbps = bench_device_transfer(b)
    return {
        "value": round(split_obs_rate, 1),
        "unit": "obs/s",
        "vs_baseline": round(split_obs_rate / VIZDOOM_I9_FPS, 3),
        "bulk_bandwidth_gbps": round(bulk_gbps, 3),
        "note": f"stage 2: host -> {b.card} upload of split-sized uint8 obs batches (64x42x42x4 from pageable memory, "
        "ended by a synchronize; per-call latency visible); bulk_bandwidth_gbps = 64 MB transfers, the ceiling "
        "pipelining can reach",
    }


def s_inference(b: Bench) -> dict:
    inf_rates = bench_pixel_inference_only(b)
    return {
        "value": round(inf_rates[4096], 1),
        "unit": "obs/s",
        "vs_baseline": round(inf_rates[4096] / VIZDOOM_I9_FPS, 3),
        "split_size_rate": round(inf_rates[64], 1),
        "note": f"stage 3: conv inference for the host-pixel model on {b.card} with the uint8 obs already on the card, "
        "at batch 4096 (compute ceiling) and at the pipeline's split size 64 (split_size_rate, launch-latency-bound)",
    }


def s_scaling(b: Bench) -> dict:
    fps1, fps2, eff = bench_scaling_proxy(b)
    return {
        "value": round(eff, 4),
        "unit": "weak_scaling_efficiency",
        "vs_baseline": round(eff / 0.80, 3),
        "fps_1proc": fps1,
        "fps_2proc_global": fps2,
        "note": f"2 gloo ranks of the host-env pipeline (serial envs, MLP 128-128) vs 1 process, each pinned to one core "
        f"and running its model on {b.card} (both ranks share cuda:0): global throughput over 2x the single process = "
        "weak-scaling efficiency of the coordination layer (the learner's all-reduces and the iteration's lockstep); "
        "the stand-in for BASELINE's >=80% multi-host target, not a measurement across cards",
    }


def s_host_pixel_gpu(b: Bench) -> dict:
    return {
        **_host_row(bench_host_pixel_gpu(b), b, HOST_KEYS + ("upload_bandwidth_mb_s", "upload_bandwidth_pageable_mb_s",
                                                             "upload_bound_ceiling_steps_s")),
        "note": f"card-fed host pipeline: 2 CPU worker procs x 1024 envs feed {b.card} (uint8 upload per split through "
        "a pinned staging copy, inference + quantized async learner on the card); compare value against "
        f"upload_bound_ceiling_steps_s (= pinned upload MB/s / {OBS_BYTES} B per obs) and the host_pipeline_* rows; "
        "vs ViZDoom battle 50K FPS on a 10-core i9",
    }


def s_grid_battle(b: Bench) -> dict:
    fps, n, fields = bench_grid_battle(b)
    return {
        "value": round(fps, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(fps / VIZDOOM_XEON_FPS, 3),
        **fields,
        "note": f"{n} on-device 24x24x3 pixel envs, IMPALA conv + GRU-256, bf16, on {b.card}: the BPTT recurrence in the "
        "hand-written gru_seq kernel (cluster design) and its backward gru_seq_cluster_bwd (rnn_kernel_launches), device busy and idle share from "
        f"torch.profiler over {b.depth.profiled} iterations; vs ViZDoom battle 137,131 FPS (36-core Xeon + GPUs)",
    }


def s_ant(b: Bench) -> dict:
    fps, n, fields = bench_ant_physics(b)
    return {
        "value": round(fps, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(fps / ISAAC_ANT_FPS, 3),
        **fields,
        "note": f"{n} on-device rigid-body ant envs (real dynamics, envs/builtin/ant.py) on {b.card} vs IsaacGym Ant "
        "PhysX 204,651 FPS (1 GPU); MFU counts MODEL flops only (physics flops excluded)",
    }


SCENARIOS = [
    ("mlp_synthetic_sync_ppo_framework_ceiling", s_mlp),
    ("host_pixel_pipeline_appo", s_host_pixel),
    ("host_pipeline_slab_producer_rate", s_producer),
    ("host_pipeline_device_put_split", s_transfer),
    ("host_pipeline_inference_only", s_inference),
    ("multihost_scaling_proxy_2proc", s_scaling),
    ("host_pixel_pipeline_appo_gpu", s_host_pixel_gpu),
    ("grid_battle_pixel_rnn_ppo", s_grid_battle),
]
HEADLINE = ("ant_physics_sync_ppo", s_ant)


def _try_scenario(suite: list, metric: str, fn, b: Bench) -> bool:
    """Run one scenario; on failure record an error row in its place (the headline must still
    print last). Every row names the card and the scenario's wall seconds, set-up included.
    Returns whether it ran."""
    start = time.perf_counter()
    try:
        row = {"metric": metric, **fn(b)}
        ok = True
    except Exception as e:  # noqa: BLE001 - a failed scenario becomes its error row; main exits 1
        import traceback

        traceback.print_exc(file=sys.stderr)
        row = {"metric": metric, "error": f"{type(e).__name__}: {e}"}
        ok = False
    suite.append({**row, **_card_fields(b.card), "seconds": round(time.perf_counter() - start, 1)})
    return ok


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description="Benchmark suite of the PyTorch/CUDA port on one NVIDIA card")
    p.add_argument("--smoke", action="store_true", help="every scenario at a cut depth (1 window of 10 iterations)")
    p.add_argument("--scaling-child", nargs=5, metavar=("PORT", "PID", "NPROC", "CORE", "TRAIN_DIR"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    depth = SMOKE if args.smoke else FULL
    if not torch.cuda.is_available():
        print("bench_gpu.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.scaling_child:
        port, pid, nproc, core = (int(x) for x in args.scaling_child[:4])
        return _scaling_child(port, pid, nproc, core, args.scaling_child[4], depth)

    device = torch.device("cuda", 0)
    b = Bench(device=device, depth=depth, card=read_card(device))
    suite = []
    ok = True
    for metric, fn in SCENARIOS:
        ok = _try_scenario(suite, metric, fn, b) and ok
        print(json.dumps(suite[-1]), flush=True)
    metric, fn = HEADLINE
    head = []
    ok = _try_scenario(head, metric, fn, b) and ok
    headline = head[0]
    headline["suite"] = suite + [{k: headline[k] for k in ("metric", "value", "unit", "vs_baseline", "error") if k in headline}]
    print(json.dumps(headline), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
