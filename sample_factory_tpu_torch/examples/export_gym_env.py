"""Export a trained gym-env policy as a `torch.export` program.

Counterpart of `sf_examples_tpu/export_gym_env.py` (reference
`sf_examples/export_onnx_gym_env.py`): the program (`export_model.py`) reloads
with `torch.export.load` without the model's Python code. For an ONNX graph use
`python -m sample_factory_tpu_torch.export_onnx` with the same arguments.

Usage (after training with train_gym_env):
    python -m sample_factory_tpu_torch.examples.export_gym_env --env=CartPole-v1 --experiment=cp1
"""

from __future__ import annotations

import functools
import sys


def main() -> int:
    from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args, register_gym_env
    from sample_factory_tpu_torch.export_model import export_model

    cfg = parse_gym_args(evaluation=True)
    register_fn = functools.partial(register_gym_env, cfg.env)
    register_fn()
    print(export_model(cfg, register_fn=register_fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
