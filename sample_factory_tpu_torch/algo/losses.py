"""PPO loss components with valids masking (counterpart of
`sample_factory_tpu/algo/losses.py`; reference `sample_factory/algo/learning/learner.py`
:431-487, :583, :646-647). Masked means replace `masked_select(...).mean()`.

Data parallelism (`parallel/mesh.py`): each rank holds some rows of a minibatch. A rank's
masked mean is its own masked sum over the minibatch's global valid `count`, so that the
ranks' values and gradients add up to the one-rank ones; `all_sum` (a packed all-reduce,
`parallel/multihost.py:all_reduce`) reduces what must be global before it is used."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

AllSum = Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]]

RATIO_CLAMP_MIN = 0.05
RATIO_CLAMP_MAX = 20.0


def _local(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    return tensors


def masked_mean(x: torch.Tensor, valids: torch.Tensor, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of `x` over the valid rows; with `count` (the global valid count, at least 1)
    this rank's part of the mean over all ranks' rows."""
    v = valids.to(x.dtype)
    return (x * v).sum() / (v.sum().clamp(min=1.0) if count is None else count)


def normalize_advantages(adv: torch.Tensor, valids: torch.Tensor, all_sum: AllSum = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked advantage normalization with the unbiased (ddof=1) std; returns (adv, mean, std).
    With `all_sum` the mean and std are those of every rank's valid rows."""
    reduce = all_sum or _local
    v = valids.to(adv.dtype)
    count, total = reduce([v.sum(), (adv * v).sum()])
    n = count.clamp(min=1.0)
    mean = total / n
    (squares,) = reduce([((adv - mean).square() * v).sum()])
    var = squares / (n - 1.0).clamp(min=1.0)
    std = var.sqrt()
    return (adv - mean) / std.clamp(min=1e-7), mean, std


def clamp_ratio(ratio: torch.Tensor) -> torch.Tensor:
    return ratio.clamp(RATIO_CLAMP_MIN, RATIO_CLAMP_MAX)


def policy_loss(ratio, adv, clip_ratio_low, clip_ratio_high, valids, count=None) -> torch.Tensor:
    clipped_ratio = ratio.clamp(clip_ratio_low, clip_ratio_high)
    loss = torch.minimum(ratio * adv, clipped_ratio * adv)
    return -masked_mean(loss, valids, count)


def value_loss(new_values, old_values, target, clip_value, valids, value_loss_coeff, count=None) -> torch.Tensor:
    value_clipped = old_values + (new_values - old_values).clamp(-clip_value, clip_value)
    loss = torch.maximum((new_values - target).square(), (value_clipped - target).square())
    return masked_mean(loss, valids, count) * value_loss_coeff


def entropy_exploration_loss(entropy, valids, exploration_loss_coeff, count=None) -> torch.Tensor:
    return -exploration_loss_coeff * masked_mean(entropy, valids, count)


def symmetric_kl_exploration_loss(kl_prior, valids, exploration_loss_coeff, count=None, all_sum: AllSum = None, world: int = 1) -> torch.Tensor:
    """The mean KL to the uniform prior, zeroed where it is not finite and clamped at 30. With
    `all_sum` the check and the clamp act on the global mean, of which this rank's `kl` is a part:
    the gradient flows where they let the global one through, and each of the `world` ranks
    otherwise reports its share of the clamped (or zeroed) value."""
    reduce = all_sum or _local
    kl = masked_mean(kl_prior, valids, count)
    (total,) = reduce([kl.detach()])
    passes = torch.isfinite(total) & (total <= 30.0)
    share = torch.where(torch.isfinite(total), total, torch.zeros_like(total)).clamp(max=30.0) / world
    return exploration_loss_coeff * torch.where(passes, kl, share)


def kl_loss(kl_old, valids, kl_loss_coeff, count=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (kl_old_mean, kl_loss)."""
    kl_old_mean = masked_mean(kl_old, valids, count)
    return kl_old_mean, kl_old_mean * kl_loss_coeff
