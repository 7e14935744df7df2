"""Using your own custom VizDoom scenario with the framework.

Counterpart of `sf_examples_tpu/vizdoom/train_custom_vizdoom_env.py` (reference
`sf_examples/vizdoom/train_custom_vizdoom_env.py`). Point --custom_doom_cfg at your
scenario's .cfg (the .wad must sit next to it), then (on the card; add --device=cpu to run
on the CPU):

    python -m sample_factory_tpu_torch.examples.vizdoom.train_custom_vizdoom_env \
        --env=doom_my_custom_env --custom_doom_cfg=/path/to/my_env.cfg \
        --experiment=my_doom_env

and evaluate with enjoy_custom_vizdoom_env using the same flags.
"""

from __future__ import annotations

import functools
import sys

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.env_utils import register_env
from sample_factory_tpu_torch.examples.vizdoom.doom.action_space import doom_action_space_extended
from sample_factory_tpu_torch.examples.vizdoom.doom_params import add_doom_env_args, doom_override_defaults
from sample_factory_tpu_torch.examples.vizdoom.doom_utils import DoomSpec, make_doom_env_from_spec, register_vizdoom_components


def add_custom_args(parser) -> None:
    parser.add_argument("--custom_doom_cfg", type=str, required=False, default=None,
                        help="Absolute path to your custom scenario .cfg file")
    parser.add_argument("--custom_doom_timeout", type=int, default=300,
                        help="Episode timeout (env frames) for the custom scenario")


def register_custom_doom_env(cfg_path: str, timeout: int) -> None:
    spec = DoomSpec(
        "doom_my_custom_env",
        cfg_path,  # absolute path: bypasses the scenario search dirs
        doom_action_space_extended(),
        reward_scaling=0.01,
        default_timeout=timeout,
    )
    register_env(spec.name, functools.partial(make_doom_env_from_spec, spec))


def parse_custom_doom_cfg(argv=None, evaluation=False):
    parser, _ = parse_sf_args(argv, evaluation=evaluation)
    add_doom_env_args(parser)
    doom_override_defaults(parser)
    add_custom_args(parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_vizdoom_components()
    cfg = parse_custom_doom_cfg()
    if not cfg.custom_doom_cfg:
        raise ValueError("--custom_doom_cfg=/abs/path/to/scenario.cfg is required")
    register_custom_doom_env(cfg.custom_doom_cfg, cfg.custom_doom_timeout)
    return run_rl(cfg)


if __name__ == "__main__":
    sys.exit(main())
