"""Train on DMLab.

Counterpart of `sf_examples_tpu/dmlab/train_dmlab.py` (reference `sf_examples/dmlab/train_dmlab.py`).
Needs deepmind_lab. Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.dmlab.train_dmlab --env=dmlab_30 --experiment=dmlab30 \
        --num_workers=32 --num_envs_per_worker=4

The encoder (image encoder ++ the instruction LSTM) is a torch module in
`examples/custom_encoders.py`, imported by `make_dmlab_encoder` when the learner builds its
model: host-env workers import this module for `register_dmlab_components` and load no torch.
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.algo.context import global_model_factory
from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.dmlab.dmlab_env import register_dmlab_envs
from sample_factory_tpu_torch.examples.dmlab.dmlab_params import add_dmlab_env_args, dmlab_override_defaults


def make_dmlab_encoder(cfg, obs_space):
    """Counterpart of `sf_examples_tpu/dmlab/dmlab_model.py:make_dmlab_encoder`."""
    from sample_factory_tpu_torch.examples.custom_encoders import DmlabEncoder

    return DmlabEncoder(cfg, obs_space)


def register_dmlab_components() -> None:
    register_dmlab_envs()
    global_model_factory().register_encoder_factory(make_dmlab_encoder)


def parse_dmlab_args(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    add_dmlab_env_args(partial_cfg.env, parser)
    dmlab_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main(argv=None) -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.examples.dmlab.dmlab_summaries import Dmlab30ScoreTracker
    from sample_factory_tpu_torch.train import make_rl_runner

    register_dmlab_components()
    cfg = parse_dmlab_args(argv)

    cfg, runner = make_rl_runner(cfg, register_fn=register_dmlab_components)
    if cfg.env == "dmlab_30":
        # human-normalized DMLab-30 scoring (IMPALA procedure)
        tracker = Dmlab30ScoreTracker(cfg)
        runner.register_episodic_stats_handler(tracker.on_episode_extra_stats)
        runner.register_observer(tracker)
    runner.init()
    return runner.run()


if __name__ == "__main__":
    sys.exit(main())
