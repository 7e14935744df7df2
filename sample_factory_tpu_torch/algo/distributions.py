"""Action distributions: categorical (with masking), diagonal Gaussian, tuple.

Counterpart of `sample_factory_tpu/algo/distributions.py` (reference
`sample_factory/algo/utils/action_distributions.py`: masked softmax :84-95,
Categorical :100-196, Tuple :197-286, Continuous :290-323).

Conventions (the trajectory schema): actions carry a trailing action dim
(Discrete -> [..., 1], Box(d) -> [..., d], Tuple -> [..., sum(num_actions)]);
log_prob/entropy/kl return shape [...].
Sampling draws its noise from a `torch.Generator`; the categorical `sample`
(Gumbel-max on uniform noise) also takes the noise as a tensor, so that a test
can feed the JAX draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from sample_factory_tpu_torch.envs.spaces import Box, Discrete, TupleSpec, num_action_parameters, num_actions


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


class ContinuousDistribution:
    """Diagonal Gaussian over flat Box actions (independent normals)."""

    stddev_min: float = 1e-4
    stddev_max: float = 1e4

    def __init__(self, params):
        # params [..., 2d] = concat(means, log_std)
        d = params.shape[-1] // 2
        self.means = params[..., :d]
        self.log_std = params[..., d:]
        self.stddevs = torch.exp(self.log_std).clamp(self.stddev_min, self.stddev_max)

    def sample(self, generator: Optional[torch.Generator] = None):
        eps = torch.randn(self.means.shape, generator=generator, device=self.means.device, dtype=self.means.dtype)
        return self.means + self.stddevs * eps

    def argmax(self):
        return self.means

    def log_prob(self, actions):
        lp = -0.5 * (actions - self.means).square() / self.stddevs.square() - torch.log(self.stddevs) - 0.5 * math.log(2 * math.pi)
        return lp.sum(dim=-1)

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.stddevs)).sum(dim=-1)

    def kl_divergence(self, other: "ContinuousDistribution"):
        kl = (
            torch.log(other.stddevs / self.stddevs)
            + (self.stddevs.square() + (self.means - other.means).square()) / (2.0 * other.stddevs.square())
            - 0.5
        )
        return kl.sum(dim=-1)

    def symmetric_kl_with_uniform_prior(self):
        # as the reference: a uniform prior over the reals is undefined, so negative entropy
        return -self.entropy()


class TupleDistribution:
    """Tuple of independent action distributions (reference :197-286)."""

    def __init__(self, space: TupleSpec, logits_flat, action_mask: Optional[Sequence] = None):
        self.space = space
        self.action_lengths = [num_actions(s) for s in space.spaces]
        self.distributions = []
        offset = 0
        for i, s in enumerate(space.spaces):
            width = num_action_parameters(s)
            mask = action_mask[i] if action_mask is not None else None
            self.distributions.append(get_action_distribution(s, logits_flat[..., offset : offset + width], mask))
            offset += width

    def sample(self, generator: Optional[torch.Generator] = None):
        return torch.cat([d.sample(generator).float() for d in self.distributions], dim=-1)

    def argmax(self):
        return torch.cat([d.argmax().float() for d in self.distributions], dim=-1)

    def log_prob(self, actions):
        parts = torch.split(actions, self.action_lengths, dim=-1)
        return sum(d.log_prob(a) for d, a in zip(self.distributions, parts))

    def entropy(self):
        return sum(d.entropy() for d in self.distributions)

    def kl_divergence(self, other: "TupleDistribution"):
        return sum(d.kl_divergence(o) for d, o in zip(self.distributions, other.distributions))

    def symmetric_kl_with_uniform_prior(self):
        return sum(d.symmetric_kl_with_uniform_prior() for d in self.distributions)


def get_action_distribution(space, raw_logits, action_mask=None):
    assert num_action_parameters(space) == raw_logits.shape[-1], (
        f"expected {num_action_parameters(space)} action params for {space}, got {raw_logits.shape[-1]}"
    )
    if isinstance(space, Discrete):
        return CategoricalDistribution(raw_logits, action_mask)
    if isinstance(space, TupleSpec):
        return TupleDistribution(space, raw_logits, action_mask)
    if isinstance(space, Box):
        return ContinuousDistribution(raw_logits)
    raise NotImplementedError(f"Action space {space!r} not supported")


def sample_actions_log_probs(distribution, generator=None):
    actions = distribution.sample(generator)
    return actions, distribution.log_prob(actions)


def argmax_actions(distribution):
    return distribution.argmax()
