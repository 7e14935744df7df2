"""Visualize/evaluate a NetHack policy.

Counterpart of `sf_examples_tpu/nethack/enjoy_nethack.py` (reference
`sf_examples/nethack/enjoy_nethack.py`). Usage (add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.nethack.enjoy_nethack --env=nethack_challenge --experiment=nh1 --no_render
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.nethack.train_nethack import parse_nethack_args, register_nethack_components


def main(argv=None) -> int:
    register_nethack_components()
    cfg = parse_nethack_args(argv, evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
