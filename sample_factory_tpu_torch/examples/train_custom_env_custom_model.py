"""Custom PIXEL env + custom model through the real host pipeline.

Counterpart of `sf_examples_tpu/train_custom_env_custom_model.py` (reference
`sf_examples/train_custom_env_custom_model.py:30-75`): each step one quadrant of a
42x42x4 uint8 screen lights up and the agent is rewarded only for naming the lit
quadrant (random policy 0.25/step, perfect 1.0/step). The task fails unless the conv
encoder sees real observations arrive intact through worker processes -> shared-memory
slabs -> uint8 upload -> the policy step -> the quantized async learner.

Also demonstrates the custom-model hook: a user-registered conv encoder via
`global_model_factory().register_encoder_factory` (reference model_factory.py:31-60).
The encoder is a torch module in `examples/custom_encoders.py`, imported by the factory
when the learner builds its model: host-env workers import this module for its register
function and load no torch. The env declares its spaces in the port's own specs, so the
example runs where gymnasium is not installed.

Usage (also the configuration `chip_smoke.py` trains on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.train_custom_env_custom_model \
        --env=my_custom_pixel_env --experiment=pixel --num_workers=2 --num_envs_per_worker=32 \
        --train_for_env_steps=300000
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from sample_factory_tpu_torch.algo.context import global_model_factory
from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.env_utils import register_env
from sample_factory_tpu_torch.envs.spaces import Box, Discrete

RES = 42
STACK = 4
EPISODE_LEN = 128


class CustomPixelEnv:
    """Batched host vector env (envpool-style: one object stepping N envs).

    Quadrant task: quadrant q in {0..3} is lit (255) each step; reward 1.0
    for action == q else 0. Episode = 128 steps, so returns range 32 (random)
    to 128 (perfect).
    """

    is_batched_vector_env = True
    gymnasium_api = True

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space = Box((RES, RES, STACK), 0.0, 255.0, "uint8")
        self.action_space = Discrete(4)
        self.rng = np.random.default_rng(seed)
        self.t = np.zeros(num_envs, np.int64)
        self.quadrant = np.zeros(num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        obs = self.rng.integers(0, 32, (self.num_envs, RES, RES, STACK), dtype=np.uint8)  # noise floor
        h = RES // 2
        for i in range(self.num_envs):
            q = self.quadrant[i]
            r0, c0 = (q // 2) * h, (q % 2) * h
            obs[i, r0 : r0 + h, c0 : c0 + h, :] = 255
        return obs

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.t[:] = 0
        self.quadrant = self.rng.integers(0, 4, self.num_envs)
        return self._obs(), {}

    def step(self, actions):
        actions = np.asarray(actions).reshape(self.num_envs)
        rewards = (actions == self.quadrant).astype(np.float32)
        self.t += 1
        terminated = np.zeros(self.num_envs, bool)
        truncated = self.t >= EPISODE_LEN
        self.t[truncated] = 0
        self.quadrant = self.rng.integers(0, 4, self.num_envs)
        return self._obs(), rewards, terminated, truncated, {}

    def close(self):
        pass


def make_custom_pixel_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    num_envs = 1
    if env_config is not None and getattr(env_config, "num_envs", None):
        num_envs = int(env_config.num_envs)
    seed = (getattr(cfg, "seed", 0) or 0) if cfg is not None else 0
    seed += int(getattr(cfg, "env_seed_offset", 0) or 0) if cfg is not None else 0
    if env_config is not None:
        seed = seed * 1000 + int(getattr(env_config, "env_id", 0) or 0)
    return CustomPixelEnv(num_envs, seed=seed)


def make_custom_pixel_encoder(cfg, obs_space):
    from sample_factory_tpu_torch.examples.custom_encoders import CustomPixelEncoder

    return CustomPixelEncoder(cfg, obs_space)


def register_custom_components() -> None:
    register_env("my_custom_pixel_env", make_custom_pixel_env)
    global_model_factory().register_encoder_factory(make_custom_pixel_encoder)


def parse_custom_args(argv=None, evaluation: bool = False):
    parser, partial_cfg = parse_sf_args(argv=argv, evaluation=evaluation)
    parser.set_defaults(
        batched_sampling=True,
        num_workers=2,
        num_envs_per_worker=32,
        worker_num_splits=2,
        rollout=32,
        batch_size=1024,
        num_epochs=1,
        async_rl=True,
        use_rnn=False,
        normalize_input=True,
        train_for_env_steps=300000,
    )
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: host-env workers import this module for its register function, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_custom_components()
    cfg = parse_custom_args()
    return run_rl(cfg, register_fn=register_custom_components)


if __name__ == "__main__":
    sys.exit(main())
