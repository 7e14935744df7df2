"""The torch encoders that the example modules register through the model factory.

They live apart from the examples: a host-env worker imports an example module for its
register function and must load no torch, so an example's encoder factory imports this
module when the learner calls it.

- `CustomPixelEncoder`: counterpart of `sf_examples_tpu/train_custom_env_custom_model.py:105-122`,
  three convs (16, 8, 4), (32, 4, 2), (32, 3, 2) and a Dense of 128, float32.
- `CustomConvEncoder`: counterpart of `sf_examples_tpu/train_pettingzoo_env.py:30-54`, convs of 32,
  64 and 128 channels (2x2, stride 1), then `encoder_conv_mlp_layers`.

Both pad as XLA's SAME does (`Conv(padding="same")`): a stride-s conv over n pixels gives
ceil(n / s), with the odd pixel of padding after, not before. The layers are named as flax
names them (`conv.i`, `dense.i`) and the encoders carry `conv_out_hwc`, so that `bridge.py`
maps the flax parameters and permutes the rows of the Dense after the convs.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sample_factory_tpu_torch.models.encoder import dense_stack
from sample_factory_tpu_torch.models.model_utils import Conv, nonlinearity


class _SameConvStack(nn.Module):
    """NHWC observation -> SAME convs (each followed by `act`) -> NCHW flatten -> dense stack."""

    def __init__(self, obs_shape: Sequence[int], filters, dense_sizes, act, cfg=None):
        super().__init__()
        height, width, channels = obs_shape
        self.act = act
        self.conv = nn.ModuleList()
        for out_ch, kernel, stride in filters:
            self.conv.append(Conv(channels, out_ch, kernel, stride, cfg, padding="same"))
            channels = out_ch
            height, width = math.ceil(height / stride), math.ceil(width / stride)
        self.conv_out_hwc = (height, width, channels)
        self.dense, self.out_features = dense_stack(cfg, height * width * channels, dense_sizes, torch.float32)

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, obs_dict):
        x = obs_dict["obs"].float()
        batch_dims = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        for layer in self.conv:
            x = self.act(layer(x))
        x = x.reshape(batch_dims + (-1,))
        for layer in self.dense:
            x = self.act(layer(x))
        return x


class CustomPixelEncoder(_SameConvStack):
    """User-supplied encoder (the custom-model hook): 3 small convs + dense, relu, float32 and
    flax's default initializers (lecun), as on the JAX side."""

    def __init__(self, cfg, obs_space, out_size: int = 128):
        super().__init__(obs_space["obs"].shape, ((16, 8, 4), (32, 4, 2), (32, 3, 2)), [out_size], F.relu)


class CustomConvEncoder(_SameConvStack):
    """Small all-convolutional encoder for tiny board observations (the action mask rides in the
    obs dict for the distribution). The JAX class pads VALID, which leaves tic-tac-toe's 3x3 board
    a 0x0 map and its policy blind to the board; SAME keeps the 3x3."""

    def __init__(self, cfg, obs_space):
        filters = [(out_ch, 2, 1) for out_ch in (32, 64, 128)]
        super().__init__(obs_space["obs"].shape, filters, cfg.encoder_conv_mlp_layers, nonlinearity(cfg), cfg)
