"""GAE and V-trace as reverse loops over time (counterpart of
`sample_factory_tpu/algo/advantages.py`; reference
`sample_factory/algo/utils/rl_utils.py:51-94` and the V-trace recursion of
`sample_factory/algo/learning/learner.py:602-639`). Time-major [T, ...] layout."""

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


def vtrace(rewards, dones, values, ratios, gamma: float, rho_hat: float = 1.0, c_hat: float = 1.0):
    """V-trace targets and advantages over a rollout segment.

    rewards/dones/values/ratios: [T, E] (values re-evaluated by the current critic).
    Returns (vs, adv), both [T, E]. As in the reference, the value after the segment's
    end is (V[T-1] - r[T-1]) / gamma, so the last delta vanishes where the segment
    does not end an episode.
    """
    dones = dones.float()
    vtrace_rho = ratios.clamp(max=rho_hat)
    vtrace_c = ratios.clamp(max=c_hat)
    next_values = (values[-1] - rewards[-1]) / gamma
    next_vs = next_values
    T = rewards.shape[0]
    vs_out, adv_out = [None] * T, [None] * T
    for t in reversed(range(T)):
        not_done_gamma = (1.0 - dones[t]) * gamma
        delta_s = vtrace_rho[t] * (rewards[t] + not_done_gamma * next_values - values[t])
        adv_out[t] = vtrace_rho[t] * (rewards[t] + not_done_gamma * next_vs - values[t])
        vs = values[t] + delta_s + not_done_gamma * vtrace_c[t] * (next_vs - next_values)
        vs_out[t] = vs
        next_values, next_vs = values[t], vs
    return torch.stack(vs_out), torch.stack(adv_out)
