"""Discretized continuous action space.

Counterpart of `sample_factory_tpu/envs/discretized.py` (reference
`sample_factory/algo/utils/spaces/discretized.py`): a Discrete space whose n
bins map linearly onto [min_action, max_action]. The framework treats it as
`Discrete` (it is one); `to_continuous` is for the env when it executes the
chosen bin, on numbers or tensors alike.
"""

from __future__ import annotations

from dataclasses import dataclass

from sample_factory_tpu_torch.envs.spaces import Discrete


@dataclass(frozen=True)
class Discretized(Discrete):
    min_action: float = -1.0
    max_action: float = 1.0

    def to_continuous(self, discrete_action):
        step = (self.max_action - self.min_action) / (self.n - 1)
        return self.min_action + discrete_action * step
