"""Train Atari through envpool's batched C++ pools.

Counterpart of `sf_examples_tpu/envpool/train_envpool_atari.py` (reference
`sf_examples/envpool/atari/train_envpool_atari.py:1-37` + `envpool_atari_utils.py`):
every `atari_*` game gets an `envpool_atari_*` twin whose env is one C++ pool per
worker-split (the batched host vector-env contract: one array call per step straight
into the shared-memory slabs, `envs/batched_host_env.py`). Preprocessing (grayscale,
resize 84x84, frameskip/max, framestack, episodic life, reward clip) happens inside
envpool's C++ threads; the adapter transposes CHW->HWC for the encoders and fixes
envpool's auto-reset semantics (terminal obs at done -> next episode's first obs,
reference envpool_wrappers.py:28-38). Needs envpool.

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.envpool.train_envpool_atari \
        --env=envpool_atari_breakout --experiment=bk1 \
        --num_envs_per_worker=32 --worker_num_splits=2
"""

from __future__ import annotations

import sys
from typing import Optional

from sample_factory_tpu_torch.cfg.arguments import parse_full_cfg, parse_sf_args
from sample_factory_tpu_torch.examples.atari.atari_params import add_atari_env_args, atari_override_defaults
from sample_factory_tpu_torch.examples.atari.atari_utils import ATARI_ENVS, AtariSpec
from sample_factory_tpu_torch.examples.envpool.envpool_utils import EnvPoolBatchedEnv, envpool_available, pool_size_and_seed
from sample_factory_tpu_torch.utils.utils import log

# NoFrameskip-v4 in gym[atari] is the same game configuration as -v5 in envpool
# (reference envpool_atari_utils.py:14-22)
ENVPOOL_ATARI_ENVS = [
    AtariSpec(
        "envpool_" + spec.name,
        spec.env_id.replace("NoFrameskip-v4", "-v5"),
        default_timeout=spec.default_timeout,
    )
    for spec in ATARI_ENVS
]


def envpool_atari_env_by_name(name: str) -> AtariSpec:
    for spec in ENVPOOL_ATARI_ENVS:
        if spec.name == name:
            return spec
    raise ValueError(f"Unknown envpool atari env {name}")


def make_envpool_atari_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not envpool_available():
        raise RuntimeError("envpool is not installed; pip install envpool")
    spec = envpool_atari_env_by_name(env_name)

    kwargs = {}
    if spec.default_timeout is not None:
        # envpool max_episode_steps does not account for frameskip
        # (reference envpool_atari_utils.py:44-46)
        kwargs["max_episode_steps"] = spec.default_timeout // 4

    num_envs, seed = pool_size_and_seed(cfg, env_config)
    return EnvPoolBatchedEnv(spec.env_id, num_envs=num_envs, seed=seed, transpose_hwc=True, **kwargs)


def register_envpool_atari_components() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for spec in ENVPOOL_ATARI_ENVS:
        register_env(spec.name, make_envpool_atari_env)


def parse_envpool_atari_args(argv=None, evaluation=False):
    parser, partial_cfg = parse_sf_args(argv, evaluation=evaluation)
    # same tuned hyperparameters as the ALE path (reference reuses
    # atari_params for the envpool variant with pool-shaped worker settings)
    add_atari_env_args(partial_cfg.env, parser)
    atari_override_defaults(partial_cfg.env, parser)
    return parse_full_cfg(parser, argv)


def main() -> int:
    # imported here: spawned host-env workers import the main module again, and stay free of torch
    from sample_factory_tpu_torch.train import run_rl

    register_envpool_atari_components()
    cfg = parse_envpool_atari_args()
    if cfg.num_workers > 4:
        log.info(
            "envpool steps envs in C++ threads: prefer few workers with large "
            "--num_envs_per_worker over many workers (reference guidance)"
        )
    return run_rl(cfg, register_fn=register_envpool_atari_components)


if __name__ == "__main__":
    sys.exit(main())
