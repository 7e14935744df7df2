"""Train on Atari (counterpart of `sf_examples_tpu/atari/train_atari.py`; reference
sf_examples/atari/train_atari.py). Needs gymnasium and ale_py.

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.atari.train_atari --env=atari_breakout --experiment=bk1
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.atari.atari_params import add_atari_env_args, atari_override_defaults
from sample_factory_tpu_torch.examples.atari.atari_utils import register_atari_components


def parse_atari_args(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    add_atari_env_args(partial_cfg.env, parser)
    atari_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_atari_components()
    cfg = parse_atari_args()
    return run_rl(cfg, register_fn=register_atari_components)


if __name__ == "__main__":
    sys.exit(main())
