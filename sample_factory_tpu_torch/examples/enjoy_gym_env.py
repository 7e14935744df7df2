"""Visualize/evaluate a policy trained with train_gym_env.

Counterpart of `sf_examples_tpu/enjoy_gym_env.py` (reference `sf_examples/enjoy_gym_env.py`).
Usage (needs gymnasium; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.enjoy_gym_env --env=CartPole-v1 --experiment=cp1 --no_render
"""

from __future__ import annotations

import functools
import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args, register_gym_env


def main() -> int:
    cfg = parse_gym_args(evaluation=True)
    register_fn = functools.partial(register_gym_env, cfg.env)
    register_fn()
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
