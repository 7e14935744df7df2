"""Optional MLP decoder between core and heads (counterpart of
`sample_factory_tpu/models/decoder.py`; reference `sample_factory/model/decoder.py`)."""

from __future__ import annotations

import torch
from torch import nn

from sample_factory_tpu_torch.models.encoder import dense_stack
from sample_factory_tpu_torch.models.model_utils import nonlinearity


class MlpDecoder(nn.Module):
    def __init__(self, cfg, input_size: int, dtype=torch.float32):
        super().__init__()
        self.act = nonlinearity(cfg)
        self.dense, self.out_features = dense_stack(cfg, input_size, cfg.decoder_mlp_layers, dtype)

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, x):
        for layer in self.dense:
            x = self.act(layer(x))
        return x


def default_make_decoder(cfg, input_size: int, dtype=torch.float32) -> nn.Module:
    return MlpDecoder(cfg, input_size, dtype)
