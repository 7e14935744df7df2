"""Policy cores: multi-layer GRU/LSTM, or identity.

Counterpart of `sample_factory_tpu/models/core.py` (reference
`sample_factory/model/core.py`: ModelCoreRNN :19, ModelCoreIdentity :67).
State layout matches the trajectory schema: one flat vector per step,
[B, rnn_num_layers * rnn_size * (2 if lstm)], LSTM as h||c per layer.
Cells are registered as `gru_<layer>` / `lstm_<layer>`, the flax names.
"""

from __future__ import annotations

import torch
from torch import nn

from sample_factory_tpu_torch.ops.rnn_cells import FusedGRUCell, FusedLSTMCell


class ModelCoreRNN(nn.Module):
    def __init__(self, cfg, input_size: int, dtype=torch.float32):
        super().__init__()
        self.is_lstm = cfg.rnn_type == "lstm"
        self.per_layer = cfg.rnn_size * (2 if self.is_lstm else 1)
        self.cell_names = []
        for layer in range(cfg.rnn_num_layers):
            cls, prefix = (FusedLSTMCell, "lstm") if self.is_lstm else (FusedGRUCell, "gru")
            name = f"{prefix}_{layer}"
            self.add_module(name, cls(input_size, cfg.rnn_size, cfg, dtype=dtype))
            self.cell_names.append(name)
            input_size = cfg.rnn_size
        self.out_features = cfg.rnn_size

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, x, flat_state, resets=None, seq: bool = False):
        """Step mode: x [B, D_in], flat_state [B, S] -> (y, new_state).
        Sequence mode (seq=True): x [T, B, D_in], resets [T, B] ->
        (y [T, B, H], final_state [B, S]), one fused sequence per layer."""
        new_states = []
        inp = x
        for layer, name in enumerate(self.cell_names):
            chunk = flat_state[:, layer * self.per_layer : (layer + 1) * self.per_layer]
            inp, new_state = getattr(self, name)(inp, chunk, resets=resets, seq=seq)
            new_states.append(new_state)
        return inp, torch.cat(new_states, dim=-1)


class ModelCoreIdentity(nn.Module):
    """No-op core for feed-forward policies (reference :67-77)."""

    def __init__(self, cfg, input_size: int, dtype=torch.float32):
        super().__init__()
        self.out_features = input_size

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, x, flat_state, resets=None, seq: bool = False):
        return x, flat_state


def default_make_core(cfg, input_size: int, dtype=torch.float32) -> nn.Module:
    return ModelCoreRNN(cfg, input_size, dtype) if cfg.use_rnn else ModelCoreIdentity(cfg, input_size, dtype)
