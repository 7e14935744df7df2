"""Train on the built-in on-device envs (counterpart of `sf_examples_tpu/train_synthetic.py`).

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.train_synthetic --env=synthetic_vector_discrete \
        --experiment=t1 --train_for_env_steps=100000
    python -m sample_factory_tpu_torch.examples.train_synthetic --env=grid_battle --use_rnn=True \
        --encoder_conv_architecture=convnet_impala --encoder_conv_mlp_layers 256 --rnn_size=256 \
        --compute_dtype=bfloat16 --num_envs=1024 --batch_size=16384 --with_vtrace=True --experiment=gb1
Envs: the synthetic_* family, grid_battle(_small), ant and ant_short.
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.envs.builtin.ant import register_ant
from sample_factory_tpu_torch.envs.builtin.synthetic import ENV_NAMES, make_synthetic_env
from sample_factory_tpu_torch.envs.env_utils import register_env
from sample_factory_tpu_torch.train import run_rl


def add_extra_params(parser):
    p = parser
    p.add_argument("--custom_env_num_actions", default=10, type=int, help="Number of actions in the synthetic env")
    p.add_argument("--custom_env_episode_len", default=16, type=int, help="Episode length of the synthetic env")


def override_defaults(parser):
    parser.set_defaults(
        use_rnn=False,
        batched_sampling=True,
        num_workers=4,
        num_envs_per_worker=16,
        rollout=32,
        recurrence=-1,
        batch_size=1024,
        encoder_mlp_layers=[128, 128],
        train_for_env_steps=100_000,
        save_every_sec=30,
        experiment_summaries_interval=5,
    )


def register_synthetic_components():
    for name in ENV_NAMES:
        register_env(name, make_synthetic_env)
    # on-device physics ant (envs/builtin/ant.py)
    register_ant("ant")
    register_ant("ant_short")


def parse_custom_args(argv=None, evaluation=False):
    parser, _ = parse_sf_args(argv, evaluation=evaluation)
    add_extra_params(parser)
    override_defaults(parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    register_synthetic_components()
    cfg = parse_custom_args()
    return run_rl(cfg)


if __name__ == "__main__":
    sys.exit(main())
