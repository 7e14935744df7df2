"""Fast parallel evaluation without a learner.

Counterpart of `sample_factory_tpu/eval.py` (reference `sample_factory/eval.py:77-119`,
`do_eval`: sampler without learner, per-episode stats to a CSV file). On-device
envs go through `enjoy`'s batched loop; host envs through the training sampler
(`HostVectorSampler`: the worker pool, or inline in --serial_mode).
"""

from __future__ import annotations

import csv
import os
import statistics
import sys
import time
from os.path import join
from typing import List, Tuple

from sample_factory_tpu_torch.cfg.arguments import load_from_checkpoint
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.utils.utils import experiment_dir, log


def _eval_device_env(cfg, num_episodes: int) -> List[Tuple[float, int]]:
    from sample_factory_tpu_torch.enjoy import enjoy

    episodes: List[Tuple[float, int]] = []
    status, _ = enjoy(cfg, num_episodes=num_episodes, num_envs=64, collect_episodes=episodes)
    if status != 0:
        raise RuntimeError("evaluation failed")
    return episodes[:num_episodes]


def _eval_host_env(cfg, num_episodes: int, register_fn=None) -> List[Tuple[float, int]]:
    import torch

    from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
    from sample_factory_tpu_torch.algo.learning import init_train_state
    from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
    from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
    from sample_factory_tpu_torch.utils.utils import resolve_device

    env_info = obtain_env_info(cfg, register_fn=register_fn)
    device = resolve_device(cfg)
    seed = cfg.seed if cfg.seed is not None else 0
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(seed)).to(device)
    ts = init_train_state(cfg, env_info, model, device)
    restored = load_checkpoint(cfg, cfg.policy_index, ts)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint for policy {cfg.policy_index}")
    log.info("Evaluating checkpoint at %d env steps", restored[0])

    sampler = HostVectorSampler(cfg, env_info, device, register_fn=register_fn)
    try:
        sampler.start()
        episodes: List[Tuple[float, int]] = []
        while len(episodes) < num_episodes:
            _, stats = sampler.collect_rollout(ts.model, ts.obs_rms, ts.train_step, cfg.policy_index)
            episodes.extend(stats["episodes"])
        return episodes[:num_episodes]
    finally:
        sampler.close()


def do_eval(cfg, register_fn=None) -> int:
    cfg = load_from_checkpoint(cfg)
    num_episodes = int(cfg.sample_env_episodes)

    env_info = obtain_env_info(cfg, register_fn=register_fn)
    t0 = time.time()
    if env_info.is_device_env:
        episodes = _eval_device_env(cfg, num_episodes)
    else:
        episodes = _eval_host_env(cfg, num_episodes, register_fn=register_fn)
    elapsed = time.time() - t0

    rewards = [r for r, _ in episodes]
    lens = [n for _, n in episodes if n >= 0]
    log.info(
        "Evaluated %d episodes in %.1fs: avg reward %.3f +/- %.3f%s",
        len(episodes),
        elapsed,
        statistics.fmean(rewards),
        statistics.pstdev(rewards),
        f", avg len {statistics.fmean(lens):.1f}" if lens else "",
    )

    out_dir = join(experiment_dir(cfg), cfg.csv_folder_name or "eval")
    os.makedirs(out_dir, exist_ok=True)
    out_path = join(out_dir, f"eval_p{cfg.policy_index}.csv")
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["episode", "reward", "length"])
        for i, (r, n) in enumerate(episodes):
            writer.writerow([i, r, n])
    log.info("Wrote %s", out_path)
    return 0


def main() -> int:
    """python -m sample_factory_tpu_torch.eval --env=... --experiment=... --sample_env_episodes=64"""
    from sample_factory_tpu_torch.enjoy import register_env_by_name
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    cfg = parse_custom_args(evaluation=True)
    return do_eval(cfg, register_fn=register_env_by_name(cfg.env))


if __name__ == "__main__":
    sys.exit(main())
