"""Train on a PettingZoo env (tictactoe_v3) with a custom conv encoder.

Counterpart of `sf_examples_tpu/train_pettingzoo_env.py` (reference
`sf_examples/train_pettingzoo_env.py`): a turn-based PettingZoo classic game converted
to a parallel env, trained through the multi-agent host pipeline with a user-registered
encoder over the dict observation {obs, action_mask}, NHWC. The encoder
(`examples/custom_encoders.py:CustomConvEncoder`) pads its convs as XLA's SAME does, so
that the 3x3 board stays 3x3; the JAX class pads VALID and leaves a 0x0 map, a policy
blind to the board (ROADMAP C records it). Needs gymnasium and pettingzoo.

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.train_pettingzoo_env --env=tictactoe_v3 \
        --experiment=ttt --use_rnn=False --recurrence=1 --batch_size=512
    python -m sample_factory_tpu_torch.examples.enjoy_pettingzoo_env --env=tictactoe_v3 --experiment=ttt --no_render
"""

from __future__ import annotations

import sys
from typing import Optional

from sample_factory_tpu_torch.algo.context import global_model_factory
from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.env_utils import register_env


def make_custom_conv_encoder(cfg, obs_space):
    # imported here: host-env workers import this module for its register function, and stay free of torch
    from sample_factory_tpu_torch.examples.custom_encoders import CustomConvEncoder

    return CustomConvEncoder(cfg, obs_space)


def make_pettingzoo_classic(full_env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    from sample_factory_tpu_torch.envs.pettingzoo_adapter import make_pettingzoo_env

    return make_pettingzoo_env(f"pettingzoo.classic.{full_env_name}", parallel=False)


def register_custom_components() -> None:
    register_env("tictactoe_v3", make_pettingzoo_classic)
    global_model_factory().register_encoder_factory(make_custom_conv_encoder)


def override_defaults(parser) -> None:
    parser.set_defaults(
        env="tictactoe_v3",
        use_rnn=False,
        recurrence=1,
        with_vtrace=False,
        batched_sampling=True,
        num_workers=2,
        num_envs_per_worker=10,
        worker_num_splits=2,
        rollout=16,
        batch_size=512,
        encoder_conv_mlp_layers=[128],
        train_for_env_steps=200_000,
        save_every_sec=10,
        experiment_summaries_interval=10,
    )


def parse_custom_args(argv=None, evaluation=False):
    parser, cfg = parse_sf_args(argv, evaluation=evaluation)
    override_defaults(parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    from sample_factory_tpu_torch.train import run_rl

    register_custom_components()
    cfg = parse_custom_args()
    return run_rl(cfg, register_fn=register_custom_components)


if __name__ == "__main__":
    sys.exit(main())
