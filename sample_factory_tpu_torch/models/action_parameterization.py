"""Action parameterization head: one linear layer producing distribution parameters.

Counterpart of `ActionParameterizationDefault` in
`sample_factory_tpu/models/action_parameterization.py` (reference
`sample_factory/model/action_parameterization.py:20`). The continuous
non-adaptive-stddev head follows with the continuous distributions (ROADMAP).
"""

from __future__ import annotations

import torch
from torch import nn

from sample_factory_tpu_torch.envs.spaces import num_action_parameters
from sample_factory_tpu_torch.models.model_utils import Dense


class ActionParameterizationDefault(nn.Module):
    def __init__(self, cfg, input_size: int, action_space, dtype=torch.float32):
        super().__init__()
        self.distribution_linear = Dense(input_size, num_action_parameters(action_space), cfg, dtype)

    def forward(self, core_output):
        return self.distribution_linear(core_output).float()
