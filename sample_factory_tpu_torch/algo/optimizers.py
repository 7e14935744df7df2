"""Optimizers: Adam, and LAMB with trust-ratio clamping and optional lookahead
(counterpart of `sample_factory_tpu/algo/optimizers.py`; reference
`sample_factory/algo/utils/optimizers.py`, Lamb from bps-nav).

The JAX chain is `scale_by_adam | scale_by_lamb_trust`, then
`scale_by_learning_rate`, then `lookahead`, under `inject_hyperparams`. Here
`torch.optim.Adam(betas=(b1, b2), eps=adam_eps)` computes the Adam update and
`Lamb` the other two in the same order; the learner sets the learning rate on
the param groups before each step (`set_lr`). Gradient clipping stays in the
learner, as on the JAX side.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


class Lamb(torch.optim.Optimizer):
    """Adam step with bias correction and weight decay inside the step, scaled per
    parameter by the trust ratio min(||w||, 10) / ||step|| clamped to
    [min_trust, 1 / min_trust] (1 where either norm is 0), then by -lr.

    With `lookahead`, the slow weights (a copy made at construction) move toward
    the updated fast weights by `alpha` on every k-th update, counted from 0 so
    that the first update syncs, and the fast weights snap to them. The update
    count sits in the param group and the slow weights in the per-parameter
    state, so both travel in `state_dict()`.

    Under tensor parallelism `model_shards` is (model axis, the split dim of each parameter or
    None), set by `parallel/mesh.py:shard_train_state`: a sharded leaf's weight and step norms
    are the whole leaf's, its squares summed over the model group in one all-reduce a step.
    """

    model_shards = None

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-6, weight_decay=1e-4, min_trust=0.01,
                 lookahead=False, lookahead_k=10, lookahead_alpha=0.5):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, min_trust=min_trust,
                        lookahead=lookahead, lookahead_k=lookahead_k, lookahead_alpha=lookahead_alpha, step=0)
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
                if lookahead:
                    state["slow"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            count = group["step"] + 1
            bc1, sqrt_bc2 = 1.0 - b1**count, math.sqrt(1.0 - b2**count)
            min_trust = group["min_trust"]
            sync = group["lookahead"] and group["step"] % group["lookahead_k"] == 0
            updates = []
            for i, p in enumerate(group["params"]):
                if p.grad is None:
                    continue
                state = self.state[p]
                mu = state["mu"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
                nu = state["nu"].mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                step = (mu / bc1) / (nu.sqrt() / sqrt_bc2 + group["eps"])
                if group["weight_decay"] > 0:
                    step = step + group["weight_decay"] * p
                updates.append((i, p, state, step))
            if min_trust != 1.0:
                norms = self._norms(updates)
            for k, (_, p, state, step) in enumerate(updates):
                if min_trust != 1.0:
                    weight_norm, step_norm = norms[k]
                    trust = (weight_norm.clamp(max=10.0) / step_norm.clamp(min=1e-20)).clamp(min_trust, 1.0 / min_trust)
                    trust = torch.where((weight_norm == 0) | (step_norm == 0), torch.ones_like(trust), trust)
                    step = step * trust
                p.add_(step, alpha=-group["lr"])
                if sync:
                    slow = state["slow"].lerp_(p, group["lookahead_alpha"])
                    p.copy_(slow)
            group["step"] = count

    def _norms(self, updates):
        """(weight norm, step norm) of each update's leaf, whole where the leaf is a shard."""
        norms = [(torch.linalg.vector_norm(p), torch.linalg.vector_norm(step)) for _, p, _, step in updates]
        if self.model_shards is None:
            return norms
        axis, dims = self.model_shards
        sharded = [k for k, (i, *_) in enumerate(updates) if dims[i] is not None]
        if sharded:
            squares = torch.stack([torch.stack(norms[k]) for k in sharded]).square()
            dist.all_reduce(squares, group=axis.group)
            for k, whole in zip(sharded, squares.sqrt()):
                norms[k] = (whole[0], whole[1])
        return norms


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    betas = (cfg.adam_beta1, cfg.adam_beta2)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=betas, eps=cfg.adam_eps)
    if cfg.optimizer == "lamb":
        return Lamb(
            params, lr=cfg.learning_rate, betas=betas, eps=cfg.adam_eps,
            lookahead=bool(getattr(cfg, "lamb_lookahead", False)),
            lookahead_k=cfg.lamb_lookahead_k, lookahead_alpha=cfg.lamb_lookahead_alpha,
        )
    raise ValueError(f"Unknown optimizer {cfg.optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
