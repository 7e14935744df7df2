"""Evaluate a policy trained by train_synthetic.py (counterpart of `sf_examples_tpu/enjoy_synthetic.py`).

Usage (on the card; add --device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.enjoy_synthetic --env=synthetic_vector_discrete --experiment=t1 --no_render
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.enjoy import enjoy
from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components


def main() -> int:
    register_synthetic_components()
    cfg = parse_custom_args(evaluation=True)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
