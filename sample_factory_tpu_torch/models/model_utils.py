"""Shared model building blocks: activations, initializers, dtype-casting layers.

Counterpart of `sample_factory_tpu/models/model_utils.py` (reference
`sample_factory/model/model_utils.py` and the weight init of
`model/actor_critic.py:73-96`). Layers keep float32 parameters and cast them,
with their input, to the compute dtype in the forward, as flax's `dtype=`
does; `--compute_dtype=bfloat16` therefore changes no stored parameter.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def nonlinearity(cfg) -> Callable:
    if cfg.nonlinearity == "elu":
        return F.elu
    if cfg.nonlinearity == "relu":
        return F.relu
    if cfg.nonlinearity == "tanh":
        return torch.tanh
    raise ValueError(f"Unknown nonlinearity {cfg.nonlinearity}")


def kernel_init_(w: torch.Tensor, cfg, fan_in: int, generator: Optional[torch.Generator] = None) -> None:
    """orthogonal / xavier_uniform / framework default (reference actor_critic.py:73-96)."""
    if cfg is None:
        nn.init.uniform_(w, -math.sqrt(3.0 / fan_in), math.sqrt(3.0 / fan_in), generator=generator)  # lecun-style
        return
    gain = cfg.policy_init_gain
    if cfg.policy_initialization == "orthogonal":
        nn.init.orthogonal_(w, gain=gain, generator=generator)
    elif cfg.policy_initialization == "xavier_uniform":
        nn.init.xavier_uniform_(w, gain=gain, generator=generator)
    else:  # "torch_default": variance scaling 1/3, fan_in, uniform
        bound = math.sqrt(1.0 / fan_in)
        nn.init.uniform_(w, -bound, bound, generator=generator)


def rnn_state_size(cfg) -> int:
    """Flat per-step RNN state width (reference model_utils.py:11-24: LSTM = h||c)."""
    if not cfg.use_rnn:
        return 1  # placeholder slot so trajectory schema is uniform
    mult = 2 if cfg.rnn_type == "lstm" else 1
    return cfg.rnn_size * cfg.rnn_num_layers * mult


def default_compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if getattr(cfg, "compute_dtype", "float32") == "bfloat16" else torch.float32


class Dense(nn.Module):
    """Linear layer with float32 params computed in `dtype` (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, in_features: int, out_features: int, cfg=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator=None) -> None:
        kernel_init_(self.weight.data, self.cfg, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis, (before, after): the output has ceil(size / stride)
    pixels, and an odd pixel of padding goes after."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor so that a VALID window of `kernel` at `stride` computes XLA's SAME."""
    top, bottom = same_padding(x.shape[-2], kernel, stride)
    left, right = same_padding(x.shape[-1], kernel, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """2-D convolution on NCHW input, float32 params computed in `dtype`, with flax's
    padding: "valid" or "same". SAME pads asymmetrically where the kernel is even or the
    stride above 1 (`nn.Conv2d` pads both sides alike and refuses "same" at a stride above
    1); for an odd kernel at stride 1 it is the conv's own `kernel // 2` on both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int, cfg=None, dtype=torch.float32,
                 padding: str = "valid"):
        super().__init__()
        assert padding in ("valid", "same"), padding
        self.cfg, self.dtype, self.kernel, self.stride = cfg, dtype, kernel, stride
        self.pad_same = padding == "same" and (stride > 1 or kernel % 2 == 0)
        self.padding = kernel // 2 if padding == "same" and not self.pad_same else 0
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator=None) -> None:
        w = self.weight.data
        kernel_init_(w.view(w.shape[0], -1), self.cfg, w[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        if self.pad_same:
            x = pad_same(x, self.kernel, self.stride)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=self.stride, padding=self.padding)


def init_parameters_(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialize every layer that defines reset_parameters(generator), in module order."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return model
