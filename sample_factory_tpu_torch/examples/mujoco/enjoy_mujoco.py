"""Visualize/evaluate a trained MuJoCo policy (counterpart of `sf_examples_tpu/mujoco/enjoy_mujoco.py`;
reference sf_examples/mujoco/enjoy_mujoco.py)."""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.mujoco.mujoco_utils import register_mujoco_components
from sample_factory_tpu_torch.examples.mujoco.train_mujoco import parse_mujoco_cfg


def main() -> int:
    register_mujoco_components()
    cfg = parse_mujoco_cfg(evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
