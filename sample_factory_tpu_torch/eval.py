"""Fast parallel evaluation without a learner.

Counterpart of `sample_factory_tpu/eval.py` (reference `sample_factory/eval.py:77-119`,
`do_eval`: sampler without learner, per-episode stats to a CSV file). On-device
envs go through `enjoy`'s batched loop; host envs wait for the host sampler
(ROADMAP A11).
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
    raise NotImplementedError("evaluation on host (gymnasium) envs is not ported yet (ROADMAP A11)")


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
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    return do_eval(parse_custom_args(evaluation=True))


if __name__ == "__main__":
    sys.exit(main())
