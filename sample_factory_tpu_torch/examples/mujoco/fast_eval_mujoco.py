"""Fast parallel evaluation -> CSV (counterpart of `sf_examples_tpu/mujoco/fast_eval_mujoco.py`;
reference sf_examples/mujoco/fast_eval_mujoco.py)."""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.eval import do_eval
from sample_factory_tpu_torch.examples.mujoco.mujoco_utils import register_mujoco_components
from sample_factory_tpu_torch.examples.mujoco.train_mujoco import parse_mujoco_cfg


def main() -> int:
    register_mujoco_components()
    cfg = parse_mujoco_cfg(evaluation=True)
    return do_eval(cfg, register_fn=register_mujoco_components)


if __name__ == "__main__":
    sys.exit(main())
