"""PPO loss components with valids masking (counterpart of
`sample_factory_tpu/algo/losses.py`; reference `sample_factory/algo/learning/learner.py`
:431-487, :583, :646-647). Masked means replace `masked_select(...).mean()`."""

from __future__ import annotations

from typing import Tuple

import torch

RATIO_CLAMP_MIN = 0.05
RATIO_CLAMP_MAX = 20.0


def masked_mean(x: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    v = valids.to(x.dtype)
    return (x * v).sum() / v.sum().clamp(min=1.0)


def normalize_advantages(adv: torch.Tensor, valids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked advantage normalization with the unbiased (ddof=1) std; returns (adv, mean, std)."""
    v = valids.to(adv.dtype)
    n = v.sum().clamp(min=1.0)
    mean = (adv * v).sum() / n
    var = ((adv - mean).square() * v).sum() / (n - 1.0).clamp(min=1.0)
    std = var.sqrt()
    return (adv - mean) / std.clamp(min=1e-7), mean, std


def clamp_ratio(ratio: torch.Tensor) -> torch.Tensor:
    return ratio.clamp(RATIO_CLAMP_MIN, RATIO_CLAMP_MAX)


def policy_loss(ratio, adv, clip_ratio_low, clip_ratio_high, valids) -> torch.Tensor:
    clipped_ratio = ratio.clamp(clip_ratio_low, clip_ratio_high)
    loss = torch.minimum(ratio * adv, clipped_ratio * adv)
    return -masked_mean(loss, valids)


def value_loss(new_values, old_values, target, clip_value, valids, value_loss_coeff) -> torch.Tensor:
    value_clipped = old_values + (new_values - old_values).clamp(-clip_value, clip_value)
    loss = torch.maximum((new_values - target).square(), (value_clipped - target).square())
    return masked_mean(loss, valids) * value_loss_coeff


def entropy_exploration_loss(entropy, valids, exploration_loss_coeff) -> torch.Tensor:
    return -exploration_loss_coeff * masked_mean(entropy, valids)


def symmetric_kl_exploration_loss(kl_prior, valids, exploration_loss_coeff) -> torch.Tensor:
    kl = masked_mean(kl_prior, valids)
    kl = torch.where(torch.isfinite(kl), kl, torch.zeros_like(kl))
    return exploration_loss_coeff * kl.clamp(max=30.0)


def kl_loss(kl_old, valids, kl_loss_coeff) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (kl_old_mean, kl_loss)."""
    kl_old_mean = masked_mean(kl_old, valids)
    return kl_old_mean, kl_old_mean * kl_loss_coeff
