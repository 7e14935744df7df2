"""Visualize a trained PettingZoo policy (counterpart of `sf_examples_tpu/enjoy_pettingzoo_env.py`;
reference `sf_examples/enjoy_pettingzoo_env.py`)."""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.train_pettingzoo_env import parse_custom_args, register_custom_components


def main() -> int:
    register_custom_components()
    cfg = parse_custom_args(evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
