"""DMLab-30 human-normalized scoring (IMPALA procedure).

Copy of `sf_examples_tpu/dmlab/dmlab_summaries.py` (reference `sf_examples/dmlab/dmlab_env.py:170-267`,
dmlab_extra_episodic_stats_processing + dmlab_extra_summaries). Procedure,
following IMPALA's scalable_agent exactly:

1. collect raw per-episode scores per level from episode_extra_stats,
2. once >=1 episode exists for EVERY level of the experiment, take the mean
   raw score per level, human-normalize it, cap at 100,
3. write per-level and mean (capped and uncapped) summaries, clear the
   accumulators, and push the capped mean into policy_avg_stats as
   `dmlab_target_objective` for PBT.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np

from sample_factory_tpu_torch.examples.dmlab.dmlab30 import DMLAB30, human_normalized_score
from sample_factory_tpu_torch.examples.dmlab.dmlab_env import (
    RAW_SCORE_SUMMARY_KEY_SUFFIX,
    dmlab_level_to_level_name,
    list_all_levels_for_experiment,
)
from sample_factory_tpu_torch.runner.runner import AlgoObserver

TARGET_OBJECTIVE_STAT = "dmlab_target_objective"


class Dmlab30ScoreTracker(AlgoObserver):
    """Register both as an episodic-stats handler and an AlgoObserver:

        tracker = Dmlab30ScoreTracker(cfg)
        runner.register_episodic_stats_handler(tracker.on_episode_extra_stats)
        runner.register_observer(tracker)
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.all_levels: List[str] = [dmlab_level_to_level_name(lvl) for lvl in list_all_levels_for_experiment(cfg.env)]
        # per policy: level name -> raw scores since the last summary flush
        self.new_level_returns: Dict[int, Dict[str, List[float]]] = {}

    def on_episode_extra_stats(self, runner, extra_stats: Dict[str, float], policy_id: int) -> None:
        for key, value in extra_stats.items():
            if RAW_SCORE_SUMMARY_KEY_SUFFIX not in key:
                continue
            # key format: z_{task_id:02d}_{level_name}_dmlab_raw_score
            level_name = key[len("z_00_") : -len(f"_{RAW_SCORE_SUMMARY_KEY_SUFFIX}")]
            per_policy = self.new_level_returns.setdefault(policy_id, {})
            per_policy.setdefault(level_name, []).append(float(value))

    def extra_summaries(self, runner, policy_id: int, writer, env_steps: int) -> None:
        per_policy = self.new_level_returns.get(policy_id)
        if not per_policy:
            return
        # IMPALA rule: only report once every level has at least one episode
        if any(len(per_policy.get(lvl, [])) < 1 for lvl in self.all_levels):
            return

        normalized, capped = [], []
        for level_idx, level in enumerate(self.all_levels):
            mean_raw = float(np.mean(per_policy[level]))
            # normalization and capping happen AFTER the mean (IMPALA order)
            score = human_normalized_score(level, mean_raw) if level in DMLAB30 else mean_raw
            normalized.append(score)
            capped.append(min(100.0, score))
            level_key = f"{level_idx:02d}_{level}"
            writer.add_scalar(f"_dmlab/{level_key}_human_norm_score", score, env_steps)
            writer.add_scalar(f"_dmlab/capped_{level_key}_human_norm_score", capped[-1], env_steps)

        mean_score, capped_mean = float(np.mean(normalized)), float(np.mean(capped))
        # 000 prefix sorts these to the top in tensorboard
        writer.add_scalar("_dmlab/000_mean_human_norm_score", mean_score, env_steps)
        writer.add_scalar("_dmlab/000_capped_mean_human_norm_score", capped_mean, env_steps)

        self.new_level_returns[policy_id] = {}

        # PBT target objective (reference runner.policy_avg_stats plumbing)
        stats = runner.policy_avg_stats.setdefault(
            TARGET_OBJECTIVE_STAT, [deque(maxlen=1) for _ in range(self.cfg.num_policies)]
        )
        stats[policy_id].append(capped_mean)
