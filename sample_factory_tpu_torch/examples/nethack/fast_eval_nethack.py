"""Fast parallel NetHack evaluation -> CSV.

Counterpart of `sf_examples_tpu/nethack/fast_eval_nethack.py` (reference
`sf_examples/nethack/fast_eval_nethack.py`, which wraps sample_factory.eval). Usage (add
--device=cpu to run on the CPU):
    python -m sample_factory_tpu_torch.examples.nethack.fast_eval_nethack --env=nethack_challenge --experiment=nh1 --sample_env_episodes=64
"""

from __future__ import annotations

import sys

from sample_factory_tpu_torch.eval import do_eval
from sample_factory_tpu_torch.examples.nethack.train_nethack import parse_nethack_args, register_nethack_components


def main(argv=None) -> int:
    register_nethack_components()
    cfg = parse_nethack_args(argv, evaluation=True)
    return do_eval(cfg, register_fn=register_nethack_components)


if __name__ == "__main__":
    sys.exit(main())
