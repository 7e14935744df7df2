"""Visualize/evaluate a trained Doom policy.

Counterpart of `sf_examples_tpu/vizdoom/enjoy_vizdoom.py` (reference
`sf_examples/vizdoom/enjoy_vizdoom.py`). Usage (add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.vizdoom.enjoy_vizdoom --env=doom_battle --experiment=battle1 --no_render
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.vizdoom.doom_utils import register_vizdoom_components
from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg


def main(argv=None) -> int:
    register_vizdoom_components()
    cfg = parse_vizdoom_cfg(argv, evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
