"""Train on MuJoCo (gymnasium) tasks.

Counterpart of `sf_examples_tpu/mujoco/train_mujoco.py` (reference
`sf_examples/mujoco/train_mujoco.py`). Needs gymnasium and mujoco. Usage (on the card;
add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.mujoco.train_mujoco --env=mujoco_halfcheetah --experiment=hc1
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.mujoco.mujoco_params import add_mujoco_env_args, mujoco_override_defaults
from sample_factory_tpu_torch.examples.mujoco.mujoco_utils import register_mujoco_components


def parse_mujoco_cfg(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    add_mujoco_env_args(partial_cfg.env, parser)
    mujoco_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_mujoco_components()
    cfg = parse_mujoco_cfg()
    return run_rl(cfg, register_fn=register_mujoco_components)


if __name__ == "__main__":
    sys.exit(main())
