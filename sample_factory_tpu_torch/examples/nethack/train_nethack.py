"""Train on NetHack.

Counterpart of `sf_examples_tpu/nethack/train_nethack.py` (reference
`sf_examples/nethack/train_nethack.py`). Needs gymnasium and nle. Usage (on the card; add
--device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.nethack.train_nethack --env=nethack_challenge --experiment=nh1

The module imports no torch: host-env workers import it for `register_nethack_components`. The
registered encoder factory imports `models.py` when the learner builds its model.
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.algo.context import global_model_factory
from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.nethack.nethack_env import register_nethack_envs
from sample_factory_tpu_torch.examples.nethack.nethack_params import (
    add_nethack_env_args,
    add_nethack_model_args,
    nethack_override_defaults,
)


def nethack_encoder_factory(cfg, obs_space):
    """`models.make_nethack_encoder`, imported at the call."""
    from sample_factory_tpu_torch.examples.nethack.models import make_nethack_encoder

    return make_nethack_encoder(cfg, obs_space)


def register_nethack_components() -> None:
    register_nethack_envs()
    global_model_factory().register_encoder_factory(nethack_encoder_factory)


def parse_nethack_args(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    add_nethack_env_args(partial_cfg.env, parser)
    add_nethack_model_args(partial_cfg.env, parser)
    nethack_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main(argv=None) -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_nethack_components()
    cfg = parse_nethack_args(argv)
    return run_rl(cfg, register_fn=register_nethack_components)


if __name__ == "__main__":
    sys.exit(main())
