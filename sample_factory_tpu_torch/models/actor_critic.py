"""Actor-critic model with shared weights.

Counterpart of `ActorCriticSharedWeights` in
`sample_factory_tpu/models/actor_critic.py:44-88` (reference
`sample_factory/model/actor_critic.py:136-196`), with the same API:
  forward_head(obs_dict) -> head_out
  forward_core(head_out, rnn_state) -> (core_out, new_state)
  forward_core_seq(head_seq [T,B,D], rnn_state, resets [T,B]) -> (core_out [T,B,H], final_state)
  forward_tail(core_out) -> (action_params_raw, values)
  forward(obs_dict, rnn_state) -> (action_params_raw, values, new_rnn_state)
Normalizer state lives in the train state, not in the module, as on the JAX side.
The separate-weights model follows in a later slice (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sample_factory_tpu_torch.envs.spaces import is_continuous_action_space
from sample_factory_tpu_torch.models.action_parameterization import ActionParameterizationDefault
from sample_factory_tpu_torch.models.core import default_make_core
from sample_factory_tpu_torch.models.decoder import default_make_decoder
from sample_factory_tpu_torch.models.encoder import default_make_encoder
from sample_factory_tpu_torch.models.model_utils import Dense, default_compute_dtype, init_parameters_, rnn_state_size


class ActorCriticSharedWeights(nn.Module):
    """encoder -> core -> decoder -> (critic linear, action head)."""

    def __init__(self, cfg, obs_space, action_space, make_encoder=None, make_core=None, make_decoder=None):
        super().__init__()
        dtype = default_compute_dtype(cfg)
        self.encoder = make_encoder(cfg, obs_space) if make_encoder else default_make_encoder(cfg, obs_space, dtype)
        head_out = self.encoder.get_out_size()
        self.core = make_core(cfg, head_out) if make_core else default_make_core(cfg, head_out, dtype)
        core_out = self.core.get_out_size()
        self.decoder = make_decoder(cfg, core_out) if make_decoder else default_make_decoder(cfg, core_out, dtype)
        decoder_out = self.decoder.get_out_size()
        self.critic_linear = Dense(decoder_out, 1, cfg, dtype)
        self.action_parameterization = ActionParameterizationDefault(cfg, decoder_out, action_space, dtype)

    def forward_head(self, obs_dict):
        return self.encoder(obs_dict)

    def forward_core(self, head_output, rnn_state):
        return self.core(head_output, rnn_state)

    def forward_core_seq(self, head_seq, rnn_state, resets):
        """BPTT: the core's sequence mode (the RNN kernels on the card)."""
        return self.core(head_seq, rnn_state, resets=resets, seq=True)

    def forward_tail(self, core_output):
        decoded = self.decoder(core_output)
        values = self.critic_linear(decoded).float()[..., 0]
        action_params = self.action_parameterization(decoded)
        return action_params, values

    def forward(self, obs_dict, rnn_state):
        x = self.forward_head(obs_dict)
        x, new_state = self.forward_core(x, rnn_state)
        action_params, values = self.forward_tail(x)
        return action_params, values, new_state


def actor_critic_rnn_state_size(cfg) -> int:
    mult = 1 if cfg.actor_critic_share_weights else 2
    return rnn_state_size(cfg) * mult


def initial_actor_critic_state(cfg, batch_size: int, device=None) -> torch.Tensor:
    return torch.zeros((batch_size, actor_critic_rnn_state_size(cfg)), device=device)


def create_actor_critic(cfg, obs_space, action_space, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Reference create_actor_critic (:337-351), honoring the model factory. Parameters are
    float32 on the CPU, initialized from `generator`; move the model to its device after."""
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    if factory.actor_critic_factory is not None:
        return factory.actor_critic_factory(cfg, obs_space, action_space)
    if not cfg.actor_critic_share_weights:
        raise NotImplementedError("--actor_critic_share_weights=False is not ported yet (ROADMAP: separate-weights model)")
    if is_continuous_action_space(action_space) and not cfg.adaptive_stddev:
        raise NotImplementedError("continuous non-adaptive stddev heads are not ported yet (ROADMAP: distributions)")
    model = ActorCriticSharedWeights(
        cfg,
        obs_space,
        action_space,
        make_encoder=factory.encoder_factory,
        make_core=factory.core_factory,
        make_decoder=factory.decoder_factory,
    )
    return init_parameters_(model, generator)
