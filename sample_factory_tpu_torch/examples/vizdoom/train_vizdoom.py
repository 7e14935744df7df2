"""Train on ViZDoom scenarios.

Counterpart of `sf_examples_tpu/vizdoom/train_vizdoom.py` (reference
`sf_examples/vizdoom/train_vizdoom.py`). Needs gymnasium and vizdoom. Usage (on the card;
add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.vizdoom.train_vizdoom --env=doom_battle --experiment=battle1
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.vizdoom.doom_params import add_doom_env_args, add_doom_env_eval_args, doom_override_defaults
from sample_factory_tpu_torch.examples.vizdoom.doom_utils import register_vizdoom_components


def parse_vizdoom_cfg(argv=None, evaluation=False):
    parser, _ = parse_sf_args(argv, evaluation=evaluation)
    add_doom_env_args(parser)
    if evaluation:
        add_doom_env_eval_args(parser)
    doom_override_defaults(parser)
    return parse_full_cfg(parser, argv)


def main(argv=None) -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_vizdoom_components()
    cfg = parse_vizdoom_cfg(argv)
    return run_rl(cfg, register_fn=register_vizdoom_components)


if __name__ == "__main__":
    sys.exit(main())
