"""GAE as a reverse loop over time (counterpart of `gae_advantages` in
`sample_factory_tpu/algo/advantages.py:20-49`; reference
`sample_factory/algo/utils/rl_utils.py:51-94`). Time-major [T, ...] layout.
V-trace follows with the async regime (ROADMAP A9)."""

from __future__ import annotations

import torch


def discounted_sum(x, dones, valids, discount: float, x_last=None):
    """Reverse discounted cumulative sum with episode-boundary resets.

    x: [T, ...] already multiplied by valids; dones/valids: [T, ...]; invalid
    steps pass the accumulator through undiscounted (rl_utils.py:52-75).
    """
    cumulative = torch.zeros_like(x[-1]) if x_last is None else x_last
    out = [None] * x.shape[0]
    for t in reversed(range(x.shape[0])):
        discount_valid = discount * valids[t] + (1.0 - valids[t])
        cumulative = x[t] + discount_valid * cumulative * (1.0 - dones[t])
        out[t] = cumulative
    return torch.stack(out)


def gae_advantages(rewards, dones, values, valids, gamma: float, gae_lambda: float):
    """rewards/dones: [T, E]; values/valids: [T+1, E] -> advantages [T, E] (rl_utils.py:77-94)."""
    dones = dones.float()
    valids = valids.float()
    deltas = (rewards - values[:-1]) * valids[:-1] + (1.0 - dones) * (gamma * values[1:] * valids[1:])
    return discounted_sum(deltas, dones, valids[:-1], gamma * gae_lambda)
