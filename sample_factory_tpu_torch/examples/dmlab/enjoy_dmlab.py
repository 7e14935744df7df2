"""Visualize/evaluate a DMLab policy.

Counterpart of `sf_examples_tpu/dmlab/enjoy_dmlab.py` (reference `sf_examples/dmlab/enjoy_dmlab.py`).
Usage (add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.dmlab.enjoy_dmlab --env=dmlab_30 --experiment=dmlab30 --no_render
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.dmlab.train_dmlab import parse_dmlab_args, register_dmlab_components


def main(argv=None) -> int:
    register_dmlab_components()
    cfg = parse_dmlab_args(argv, evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
