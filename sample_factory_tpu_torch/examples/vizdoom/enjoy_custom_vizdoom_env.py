"""Evaluate a policy trained on a custom VizDoom scenario.

Counterpart of `sf_examples_tpu/vizdoom/enjoy_custom_vizdoom_env.py` (reference
`sf_examples/vizdoom/enjoy_custom_vizdoom_env.py`): the flags of train_custom_vizdoom_env.
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.vizdoom.doom_utils import register_vizdoom_components
from sample_factory_tpu_torch.examples.vizdoom.train_custom_vizdoom_env import parse_custom_doom_cfg, register_custom_doom_env


def main() -> int:
    register_vizdoom_components()
    cfg = parse_custom_doom_cfg(evaluation=True)
    if not cfg.custom_doom_cfg:
        raise ValueError("--custom_doom_cfg=/abs/path/to/scenario.cfg is required")
    register_custom_doom_env(cfg.custom_doom_cfg, cfg.custom_doom_timeout)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
