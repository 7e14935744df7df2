"""Optimizer (counterpart of `make_optimizer` in `sample_factory_tpu/algo/optimizers.py:107-130`).

The JAX chain is optax `scale_by_adam(b1, b2, eps)` then `scale_by_learning_rate`
under `inject_hyperparams`: `torch.optim.Adam(betas=(b1, b2), eps=adam_eps)` computes
the same update, and the learner sets the learning rate on the param group
before each step. Gradient clipping stays in the learner, as on the JAX side.
LAMB and lookahead follow in a later slice (ROADMAP).
"""

from __future__ import annotations

import torch


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"--optimizer={cfg.optimizer} is not ported yet (ROADMAP: LAMB/lookahead)")
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
