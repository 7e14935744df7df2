"""Categorical action distribution with optional masking.

Counterpart of `CategoricalDistribution` in `sample_factory_tpu/algo/distributions.py:32-100`
(reference `sample_factory/algo/utils/action_distributions.py`: masked softmax
:84-95, Categorical :100-196). Continuous and tuple distributions follow in a
later slice (ROADMAP).

Conventions (the trajectory schema): actions carry a trailing action dim
(Discrete -> [..., 1]); log_prob/entropy/kl return shape [...].
Sampling is Gumbel-max on uniform noise from a `torch.Generator`; `sample`
also takes the noise as a tensor, so that a test can feed the JAX draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from sample_factory_tpu_torch.envs.spaces import Discrete, num_action_parameters


def masked_softmax(logits, mask):
    logits = torch.where(mask == 0, torch.full_like(logits, -1e9), logits)
    p = F.softmax(logits, dim=-1) * mask
    return p / (p.sum(dim=-1, keepdim=True) + 1e-13)


def masked_log_softmax(logits, mask):
    logits = torch.where(mask == 0, torch.full_like(logits, -1e9), logits)
    return F.log_softmax(logits, dim=-1)


class CategoricalDistribution:
    def __init__(self, raw_logits, action_mask=None):
        self.raw_logits = raw_logits
        self.action_mask = action_mask
        self._p = None
        self._log_p = None

    @property
    def num_categories(self) -> int:
        return self.raw_logits.shape[-1]

    @property
    def probs(self):
        if self._p is None:
            if self.action_mask is not None:
                self._p = masked_softmax(self.raw_logits, self.action_mask)
            else:
                self._p = F.softmax(self.raw_logits, dim=-1)
        return self._p

    @property
    def log_probs_tensor(self):
        if self._log_p is None:
            if self.action_mask is not None:
                self._log_p = masked_log_softmax(self.raw_logits, self.action_mask)
            else:
                self._log_p = F.log_softmax(self.raw_logits, dim=-1)
        return self._log_p

    def sample(self, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None):
        """Gumbel-max sampling; `uniform` is noise in [1e-20, 1) of the logits' shape,
        drawn from `generator` when not given (as `jax.random.uniform(minval=1e-20)`)."""
        logits = self.log_probs_tensor if self.action_mask is not None else self.raw_logits
        if uniform is None:
            uniform = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
        return torch.argmax(logits + gumbel, dim=-1, keepdim=True).to(torch.int32)

    def argmax(self):
        return torch.argmax(self.probs, dim=-1, keepdim=True).to(torch.int32)

    def log_prob(self, actions):
        return self.log_probs_tensor.gather(-1, actions[..., :1].long())[..., 0]

    def entropy(self):
        return -(self.log_probs_tensor * self.probs).sum(dim=-1)

    def kl_divergence(self, other: "CategoricalDistribution"):
        return (self.probs * (self.log_probs_tensor - other.log_probs_tensor)).sum(dim=-1)

    def symmetric_kl_with_uniform_prior(self):
        n = self.num_categories
        log_uniform = math.log(1.0 / n)
        probs, log_probs = self.probs, self.log_probs_tensor
        fwd = (probs * (log_probs - log_uniform)).sum(dim=-1)
        bwd = ((1.0 / n) * (log_uniform - log_probs)).sum(dim=-1)
        return 0.5 * (fwd + bwd)


def get_action_distribution(space, raw_logits, action_mask=None):
    assert num_action_parameters(space) == raw_logits.shape[-1], (
        f"expected {num_action_parameters(space)} action params for {space}, got {raw_logits.shape[-1]}"
    )
    if isinstance(space, Discrete):
        return CategoricalDistribution(raw_logits, action_mask)
    raise NotImplementedError(f"Action space {space!r} is not ported yet (ROADMAP: continuous/tuple distributions)")


def sample_actions_log_probs(distribution, generator=None):
    actions = distribution.sample(generator)
    return actions, distribution.log_prob(actions)
