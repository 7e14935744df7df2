"""Action parameterization heads: a linear layer producing distribution parameters.

Counterpart of `sample_factory_tpu/models/action_parameterization.py` (reference
`sample_factory/model/action_parameterization.py`: the default head :20 and the
continuous head with a single learned log-std vector and optional tanh
squashing of the means :42-76).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sample_factory_tpu_torch.envs.spaces import num_action_parameters
from sample_factory_tpu_torch.models.model_utils import Dense
from sample_factory_tpu_torch.parallel.tensor_parallel import full_param


class ActionParameterizationDefault(nn.Module):
    def __init__(self, cfg, input_size: int, action_space, dtype=torch.float32):
        super().__init__()
        self.distribution_linear = Dense(input_size, num_action_parameters(action_space), cfg, dtype)

    def forward(self, core_output):
        return self.distribution_linear(core_output).float()


class ActionParameterizationContinuousNonAdaptiveStddev(nn.Module):
    """Means from the net; the log-stddev is one learned vector, the same in every state."""

    takes_model_shards = "gathered"

    def __init__(self, cfg, input_size: int, action_space, dtype=torch.float32):
        super().__init__()
        d = num_action_parameters(action_space) // 2
        self.tanh_scale = cfg.continuous_tanh_scale
        self.distribution_linear = Dense(input_size, d, cfg, dtype)
        self.learned_stddev = nn.Parameter(torch.full((d,), math.log(cfg.initial_stddev)))

    def forward(self, core_output):
        means = self.distribution_linear(core_output).float()
        if self.tanh_scale > 0:
            means = torch.tanh(means / self.tanh_scale) * self.tanh_scale
        return torch.cat([means, full_param(self, "learned_stddev").expand_as(means)], dim=-1)
