"""Visualize an IsaacGym policy.

Counterpart of `sf_examples_tpu/isaacgym_examples/enjoy_isaacgym.py` (reference
`sf_examples/isaacgym_examples/enjoy_isaacgym.py`). Usage (add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.isaacgym_examples.enjoy_isaacgym --env=Ant --experiment=ant1 --no_render
"""

from __future__ import annotations

import sys

# first: `train_isaacgym` imports isaacgym, which must come before torch
from sample_factory_tpu_torch.examples.isaacgym_examples.train_isaacgym import parse_isaacgym_args, register_isaacgym_components
from sample_factory_tpu_torch.enjoy import enjoy


def main(argv=None) -> int:
    register_isaacgym_components()
    cfg = parse_isaacgym_args(argv, evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
