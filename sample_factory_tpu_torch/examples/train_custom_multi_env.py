"""Multi-agent host-env example: 2-agent coordination game with multi-policy
self-play.

Counterpart of `sf_examples_tpu/train_custom_multi_env.py` (reference
`sf_examples/train_custom_multi_env.py`): a 2-agent matching game (agents get 0
when they pick the same action, a penalty otherwise; optimal joint return is 0),
with random agent deactivation to exercise inactive-agent masking, and reward
shaping hooks for PBT. Pure numpy, and its spaces are declared in the port's own
specs, so it runs where gymnasium is not installed.

Usage:
    python -m sample_factory_tpu_torch.examples.train_custom_multi_env --env=my_custom_multi_env_v1 \
        --experiment=multi --num_policies=2
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.env_utils import RewardShapingInterface, TrainingInfoInterface, register_env
from sample_factory_tpu_torch.envs.spaces import Box, Discrete


class CustomMultiEnv(TrainingInfoInterface, RewardShapingInterface):
    """2-agent matching game. step() takes a list of actions and returns lists
    (the framework's multi-agent host-env convention, same as the reference)."""

    def __init__(self, full_env_name, cfg, render_mode: Optional[str] = None):
        self.name = full_env_name
        self.cfg = cfg
        self.curr_episode_steps = 0
        self.episode_len = getattr(cfg, "custom_env_episode_len", 16) if cfg is not None else 16

        self.observation_space = Box((8,), 0.0, 1.0, "float32")
        self.action_space = Discrete(2)

        self.num_agents = 2
        self.is_multiagent = True
        self.inactive_steps = [3] * self.num_agents
        self.reward_shaping = [dict(rew=-1.0) for _ in range(self.num_agents)]
        self.render_mode = render_mode
        self._rng = np.random.default_rng()

    def _obs(self):
        return [self._rng.random(8, dtype=np.float32) for _ in range(self.num_agents)]

    def reset(self, seed=None, **kwargs):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.curr_episode_steps = 0
        return self._obs(), [dict() for _ in range(self.num_agents)]

    def step(self, actions):
        infos = [dict() for _ in range(self.num_agents)]

        # random deactivation exercises inactive-agent masking
        for i in range(self.num_agents):
            if self.inactive_steps[i] > 0:
                self.inactive_steps[i] -= 1
            elif random.random() < 0.005:
                self.inactive_steps[i] = random.randint(1, 48)
            infos[i]["is_active"] = self.inactive_steps[i] <= 0

        self.curr_episode_steps += 1

        # matching game: same action -> 0, different -> shaped penalty
        penalty0 = self.reward_shaping[0]["rew"]
        penalty1 = self.reward_shaping[1]["rew"]
        if int(actions[0]) == int(actions[1]):
            rewards = [0.0, 0.0]
        else:
            rewards = [penalty0, penalty1]
        for i in range(self.num_agents):
            if not infos[i]["is_active"]:
                rewards[i] = 0.0

        timeout = self.curr_episode_steps >= self.episode_len
        terminated = [timeout] * self.num_agents
        truncated = [False] * self.num_agents
        return self._obs(), rewards, terminated, truncated, infos

    def get_default_reward_shaping(self):
        return self.reward_shaping[0]

    def set_reward_shaping(self, reward_shaping, agent_idx) -> None:
        if isinstance(agent_idx, int):
            agent_idx = slice(agent_idx, agent_idx + 1)
        for i in range(agent_idx.start, agent_idx.stop):
            self.reward_shaping[i] = reward_shaping

    def render(self):
        pass

    def close(self):
        pass


def make_custom_multi_env_func(full_env_name, cfg=None, env_config=None, render_mode: Optional[str] = None):
    return CustomMultiEnv(full_env_name, cfg, render_mode=render_mode)


ENV_NAME = "my_custom_multi_env_v1"


def register_custom_components():
    register_env(ENV_NAME, make_custom_multi_env_func)


def add_extra_params(parser):
    parser.add_argument("--custom_env_episode_len", default=16, type=int, help="Episode length")


def override_defaults(parser):
    parser.set_defaults(
        use_rnn=False,
        batched_sampling=True,
        num_workers=2,
        num_envs_per_worker=8,
        worker_num_splits=2,
        rollout=16,
        batch_size=512,
        encoder_mlp_layers=[64, 64],
        train_for_env_steps=100_000,
        save_every_sec=10,
        experiment_summaries_interval=5,
    )


def parse_custom_args(argv=None, evaluation=False):
    parser, cfg = parse_sf_args(argv, evaluation=evaluation)
    add_extra_params(parser)
    override_defaults(parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: host-env workers import this module for its register function, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_custom_components()
    cfg = parse_custom_args()
    return run_rl(cfg, register_fn=register_custom_components)


if __name__ == "__main__":
    sys.exit(main())
