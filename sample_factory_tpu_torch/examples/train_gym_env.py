"""Train on any gymnasium environment by name (host-env path).

Counterpart of `sf_examples_tpu/train_gym_env.py` (reference
`sf_examples/train_gym_env.py`, the CartPole-v1 smoke-test entry). Usage (on the
card; add --device=cpu to run on the CPU, --serial_mode=True to step the envs in
this process for debugging, --async_rl=False for on-policy PPO):
    python -m sample_factory_tpu_torch.examples.train_gym_env --env=CartPole-v1 --experiment=cp1
    python -m sample_factory_tpu_torch.enjoy --env=CartPole-v1 --experiment=cp1 --no_render
Needs gymnasium; `envs/batched_host_env.py` and `examples/train_custom_multi_env.py`
hold host envs that run without it.
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.env_utils import register_env


def make_gym_env_func(full_env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    import gymnasium as gym

    return gym.make(full_env_name, render_mode=render_mode)


def register_gym_env(env_name: str) -> None:
    register_env(env_name, make_gym_env_func)


def override_defaults(parser):
    parser.set_defaults(
        use_rnn=False,
        batched_sampling=True,
        num_workers=4,
        num_envs_per_worker=8,
        worker_num_splits=2,
        rollout=32,
        recurrence=-1,
        batch_size=512,
        encoder_mlp_layers=[128, 128],
        train_for_env_steps=200_000,
        save_every_sec=60,
        experiment_summaries_interval=5,
    )


def parse_gym_args(argv=None, evaluation=False):
    parser, cfg = parse_sf_args(argv, evaluation=evaluation)
    override_defaults(parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: host-env workers import this module for its register function, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    cfg = parse_gym_args()
    register_fn = functools.partial(register_gym_env, cfg.env)
    register_fn()
    return run_rl(cfg, register_fn=register_fn)


if __name__ == "__main__":
    sys.exit(main())
