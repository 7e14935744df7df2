"""Observation encoders: MLP, conv stacks, IMPALA resnet, multi-input.

Counterpart of `sample_factory_tpu/models/encoder.py` (reference
`sample_factory/model/encoder.py`: MultiInputEncoder :33, MlpEncoder :72,
ConvEncoder :122-151, ResnetEncoder :173-231). Observations stay NHWC at the encoder's interface, as on
the JAX side; the conv stack permutes to NCHW inside and flattens in NCHW
order. `bridge.py` permutes the rows of the first Dense after the convs so that
parameters carried over from flax give the same function.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sample_factory_tpu_torch.models.model_utils import Conv, Dense, nonlinearity

# conv filter stacks: (out_channels, kernel, stride), VALID padding
CONV_FILTERS = {
    "convnet_simple": [(32, 8, 4), (64, 4, 2), (128, 3, 2)],
    "convnet_impala": [(16, 8, 4), (32, 4, 2)],
    "convnet_atari": [(32, 8, 4), (64, 4, 2), (64, 3, 1)],
}


def dense_stack(cfg, in_features: int, sizes: Sequence[int], dtype) -> Tuple[nn.ModuleList, int]:
    layers = nn.ModuleList()
    for size in sizes:
        layers.append(Dense(in_features, size, cfg, dtype))
        in_features = size
    return layers, in_features


class MlpEncoder(nn.Module):
    def __init__(self, cfg, in_features: int, dtype=torch.float32):
        super().__init__()
        self.act = nonlinearity(cfg)
        self.dtype = dtype
        self.dense, self.out_features = dense_stack(cfg, in_features, cfg.encoder_mlp_layers, dtype)

    def forward(self, obs):
        x = obs.to(self.dtype)
        for layer in self.dense:
            x = self.act(layer(x))
        return x


def conv_output_hw(height: int, width: int, filters) -> Tuple[int, int]:
    for _, kernel, stride in filters:
        height = max(0, (height - kernel) // stride + 1)
        width = max(0, (width - kernel) // stride + 1)
    return height, width


class ConvEncoder(nn.Module):
    def __init__(self, cfg, obs_shape: Sequence[int], dtype=torch.float32):
        super().__init__()
        height, width, channels = obs_shape
        filters = CONV_FILTERS[cfg.encoder_conv_architecture]
        out_h, out_w = conv_output_hw(height, width, filters)
        if out_h < 1 or out_w < 1:
            # a VALID stack on a too-small image leaves no pixels; flax returns an
            # (N, 0, 0, C) map and the Dense after it sees nothing
            raise ValueError(
                f"{cfg.encoder_conv_architecture} on a {height}x{width} observation leaves a {out_h}x{out_w} "
                f"feature map: the image is too small for this conv stack"
            )
        self.act = nonlinearity(cfg)
        self.dtype = dtype
        self.conv = nn.ModuleList()
        for out_ch, kernel, stride in filters:
            self.conv.append(Conv(channels, out_ch, kernel, stride, cfg, dtype))
            channels = out_ch
        self.conv_out_hwc = (out_h, out_w, channels)
        self.dense, self.out_features = dense_stack(cfg, out_h * out_w * channels, cfg.encoder_conv_mlp_layers, dtype)

    def forward(self, obs):
        """obs: [..., H, W, C] float (already normalized)."""
        x = obs.to(self.dtype)
        batch_dims = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        for layer in self.conv:
            x = self.act(layer(x))
        x = x.reshape(batch_dims + (-1,))
        for layer in self.dense:
            x = self.act(layer(x))
        return x


class ResBlock(nn.Module):
    def __init__(self, cfg, channels: int, dtype=torch.float32):
        super().__init__()
        self.act = nonlinearity(cfg)
        self.conv = nn.ModuleList([Conv(channels, channels, 3, 1, cfg, dtype, padding=1) for _ in range(2)])

    def forward(self, x):
        out = self.conv[0](self.act(x))
        out = self.conv[1](self.act(out))
        return out + x


RESNET_CONF = ((16, 2), (32, 2), (32, 2))  # (channels, res blocks) per stage


def max_pool_same(x):
    """3x3 max-pool at stride 2 with XLA's SAME padding: an even size is padded by 0 before
    and 1 after, an odd size by 1 on both sides (`nn.MaxPool2d(padding=1)` pads both sides
    always). The padding is -inf, so it never wins."""
    h, w = x.shape[-2:]
    x = F.pad(x, (w % 2, 1, h % 2, 1), value=float("-inf"))
    return F.max_pool2d(x, 3, stride=2)


class ResnetEncoder(nn.Module):
    """IMPALA resnet: three stages of conv, max-pool and two residual blocks (reference :173-231)."""

    def __init__(self, cfg, obs_shape: Sequence[int], dtype=torch.float32):
        super().__init__()
        height, width, channels = obs_shape
        self.act = nonlinearity(cfg)
        self.dtype = dtype
        self.conv = nn.ModuleList()
        self.resblock = nn.ModuleList()
        self.blocks_per_stage = [blocks for _, blocks in RESNET_CONF]
        for out_ch, blocks in RESNET_CONF:
            self.conv.append(Conv(channels, out_ch, 3, 1, cfg, dtype, padding=1))
            self.resblock.extend(ResBlock(cfg, out_ch, dtype) for _ in range(blocks))
            channels = out_ch
            height, width = (height + 1) // 2, (width + 1) // 2
        self.conv_out_hwc = (height, width, channels)
        self.dense, self.out_features = dense_stack(cfg, height * width * channels, cfg.encoder_conv_mlp_layers, dtype)

    def forward(self, obs):
        """obs: [..., H, W, C] float (already normalized)."""
        x = obs.to(self.dtype)
        batch_dims = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        blocks = iter(self.resblock)
        for conv, num_blocks in zip(self.conv, self.blocks_per_stage):
            x = max_pool_same(conv(x))
            for _ in range(num_blocks):
                x = next(blocks)(x)
        x = self.act(x).reshape(batch_dims + (-1,))
        for layer in self.dense:
            x = self.act(layer(x))
        return x


def make_img_encoder(cfg, obs_shape, dtype):
    if cfg.encoder_conv_architecture.startswith("convnet"):
        return ConvEncoder(cfg, obs_shape, dtype=dtype)
    if cfg.encoder_conv_architecture.startswith("resnet"):
        return ResnetEncoder(cfg, obs_shape, dtype=dtype)
    raise NotImplementedError(f"Unknown conv architecture {cfg.encoder_conv_architecture}")


class MultiInputEncoder(nn.Module):
    """Encode each obs key (sorted order) and concatenate (reference :33-70).

    1-D subspaces get the MLP encoder, >=2-D get a conv or resnet encoder. `action_mask`
    rides in the obs dict but feeds the action distribution, not the encoder.
    """

    def __init__(self, cfg, obs_space, dtype=torch.float32):
        super().__init__()
        self.encoders = nn.ModuleDict()
        self.keys = [k for k in sorted(obs_space.keys()) if k != "action_mask"]
        for key in self.keys:
            shape = obs_space[key].shape
            if len(shape) == 1:
                enc = MlpEncoder(cfg, shape[0], dtype=dtype)
            else:
                enc = make_img_encoder(cfg, shape, dtype)
            self.encoders[f"enc_{key}"] = enc
        self.out_features = sum(e.out_features for e in self.encoders.values())

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, obs_dict: Dict[str, torch.Tensor]):
        encodings = [self.encoders[f"enc_{k}"](obs_dict[k]) for k in self.keys]
        if len(encodings) == 1:
            return encodings[0]
        return torch.cat(encodings, dim=-1)


def default_make_encoder(cfg, obs_space, dtype=torch.float32) -> nn.Module:
    """Reference default_make_encoder_func (:234-242)."""
    return MultiInputEncoder(cfg, obs_space, dtype=dtype)
