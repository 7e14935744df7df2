"""NetHack policy encoders as torch modules.

Counterpart of `sf_examples_tpu/nethack/models.py` (reference `sf_examples/nethack/models/`):

- ChaoticDwarvenGPT5 (nle-sample-factory-baseline): topline one-hot MLP,
  bottom-2-lines char/digit-channel 1D conv, screen-image conv stack,
  prev-action one-hot.
- ScaledNet ("Scaling Laws for Imitation Learning in NetHack",
  arXiv:2307.09423): char+color embeddings of the tty map, IMPALA-style
  conv/resnet trunk, cursor-centered crop branch, wide fc head.

As on the JAX side: observations are NHWC at the interface; the cursor crop is a window of a
map zero-padded by `crop // 2` whose start is taken as `lax.dynamic_slice` takes it (a negative
start counts from the end, then the start is clamped into the padded map:
`crop_around_cursor_clamped`), not the zero-padded crop of the numpy `crop_around_cursor`;
ScaledNet normalizes with GroupNorm (flax's: groups `min(8, C)`, epsilon 1e-6, statistics in
float32) where the reference has BatchNorm; every dim is derived from the obs space, so the models
build without nle.

Where the JAX side differs from this module:
- Leading dims are any: [B, ...] in a rollout, [S, R, ...] in the learner. The flax classes take
  `B = tty.shape[0]` and index `tty[:, 0, :]`, so the learner's [S, R, 24, 80] observations raise
  there (`ScopeParamShapeError`): the JAX NetHack example cannot run a train call.
- Layouts. The convs run NCHW (2-D) and NCL (1-D), and each encoder permutes back to NHWC / NLC
  before the flatten that feeds a Dense (`screen.fc`, `bottomline.blf_fc0`, `screen.fc` of
  ScaledNet, the crop branch): the flatten is in the JAX order, so `bridge.py` carries those
  Denses' kernels without a row permutation. `bridge.py` transposes the 1-D conv kernels
  ([K, I, O] to `weight` [O, I, K]) and renames GroupNorm's `scale` to `weight`.

The layers are named as the flax modules name them (`topline.msg_fc0`, `screen.conv0`,
`screen.res0_1.norm1`, `crop_conv4`, `head_fc1`, ...), and take the cfg's compute dtype.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sample_factory_tpu_torch.examples.custom_encoders import Embed
from sample_factory_tpu_torch.models.model_utils import Conv, Dense, default_compute_dtype, kernel_init_

NUM_CHARS = 256
NUM_COLORS = 128


def one_hot(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a row of zeros for an id outside [0, n)."""
    return (ids.long()[..., None] == torch.arange(n, device=ids.device)).to(dtype)


class Conv1d(nn.Module):
    """flax `nn.Conv` with one spatial dim, VALID: NCL input, float32 params computed in `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int, dtype=torch.float32):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator=None) -> None:
        w = self.weight.data
        kernel_init_(w.view(w.shape[0], -1), None, w[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=self.stride)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` on NCHW: mean and E[x^2] in float32, variance E[x^2] - mean^2 clipped at
    0, epsilon 1e-6, the affine in float32, the result in `dtype`."""

    flax_weight_name = "scale"

    def __init__(self, num_groups: int, channels: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.dtype, self.eps = num_groups, dtype, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.float()
        groups = xf.reshape(n, self.num_groups, -1)
        mean = groups.mean(-1)
        var = torch.clamp((groups * groups).mean(-1) - mean * mean, min=0.0)
        size = c // self.num_groups
        mul = torch.rsqrt(var + self.eps).repeat_interleave(size, 1) * self.weight
        mean = mean.repeat_interleave(size, 1)
        y = (xf - mean[:, :, None, None]) * mul[:, :, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


def _elu_mlp(module: nn.Module, x, prefix: str, count: int):
    for i in range(count):
        x = F.elu(getattr(module, f"{prefix}_fc{i}")(x))
    return x


def _nhwc_flatten(x):
    """NCHW -> the NHWC flatten of the JAX encoders."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class TopLineEncoder(nn.Module):
    """One-hot(256) of the top tty line -> 2-layer MLP (reference chaotic_dwarf.py:109-125). The
    one-hot matmul is the embedding lookup: one [N, W*256] x [W*256, H] product."""

    def __init__(self, width: int, hidden: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.msg_fc0 = Dense(width * NUM_CHARS, hidden, dtype=dtype)
        self.msg_fc1 = Dense(hidden, hidden, dtype=dtype)
        self.out_features = hidden

    def forward(self, topline):  # [N, W] int
        x = one_hot(topline, NUM_CHARS, self.dtype).reshape(topline.shape[0], -1)
        return _elu_mlp(self, x, "msg", 2)


class BottomLinesEncoder(nn.Module):
    """Bottom two tty lines -> (char, digit) channels -> 1D convs -> MLP
    (reference chaotic_dwarf.py:128-158): characters normalized over the
    visible-ASCII range, digits parsed as values in a second channel."""

    CONVS = ((32, 8, 4), (64, 4, 1))

    def __init__(self, length: int, hidden: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        channels = 2
        for i, (out_ch, k, s) in enumerate(self.CONVS):
            setattr(self, f"conv{i}", Conv1d(channels, out_ch, k, s, dtype))
            channels, length = out_ch, (length - k) // s + 1
        self.blf_fc0 = Dense(length * channels, hidden, dtype=dtype)
        self.blf_fc1 = Dense(hidden, hidden, dtype=dtype)
        self.out_features = hidden

    def forward(self, bottom_lines):  # [N, D] int or float
        x = bottom_lines.to(self.dtype)
        chars_norm = (x - 32.0) / 96.0
        digit_mask = torch.logical_and(x > 44, x < 58).to(self.dtype)
        digits_norm = digit_mask * (x - 47.0) / 10.0
        h = torch.stack([chars_norm, digits_norm], dim=1)  # [N, 2, D]
        for i in range(len(self.CONVS)):
            h = F.elu(getattr(self, f"conv{i}")(h))
        h = h.transpose(1, 2).reshape(h.shape[0], -1)  # the NLC flatten of the JAX encoder
        return _elu_mlp(self, h, "blf", 2)


class ScreenEncoder(nn.Module):
    """Conv stack over the tiled tty image [N, H, W, C] (reference
    chaotic_dwarf.py:188-233), scaled to [0, 1]."""

    CONVS = ((32, 8, 6), (64, 4, 2), (128, 3, 2), (128, 3, 1))

    def __init__(self, shape: Sequence[int], hidden: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        height, width, channels = shape
        for i, (out_ch, k, s) in enumerate(self.CONVS):
            setattr(self, f"conv{i}", Conv(channels, out_ch, k, s, dtype=dtype))
            channels, height, width = out_ch, (height - k) // s + 1, (width - k) // s + 1
        self.fc = Dense(height * width * channels, hidden, dtype=dtype)
        self.out_features = hidden

    def forward(self, screen):
        x = (screen.to(self.dtype) / 255.0).permute(0, 3, 1, 2)
        for i in range(len(self.CONVS)):
            x = F.elu(getattr(self, f"conv{i}")(x))
        return F.elu(self.fc(_nhwc_flatten(x)))


def _flat_obs(obs_dict, obs_space):
    """Every key to [N, ...] by its space's trailing shape; the leading dims."""
    lead = obs_dict["tty_chars"].shape[: obs_dict["tty_chars"].dim() - 2]
    flat = {k: v.reshape((-1,) + tuple(obs_space[k].shape)) for k, v in obs_dict.items() if k in obs_space.keys()}
    return flat, lead


class ChaoticDwarvenGPT5(nn.Module):
    """topline ++ bottomlines ++ screen ++ prev-action one-hot."""

    def __init__(self, cfg, obs_space, dtype=torch.float32):
        super().__init__()
        self.cfg, self.obs_space, self.dtype = cfg, obs_space, dtype
        tty = obs_space["tty_chars"].shape
        if cfg.use_tty_only:
            top_width, bottom_len = tty[1], 2 * tty[1]
        else:
            top_width, bottom_len = obs_space["message"].shape[0], obs_space["blstats"].shape[0]
        self.topline = TopLineEncoder(top_width, dtype=dtype)
        self.bottomline = BottomLinesEncoder(bottom_len, dtype=dtype)
        self.screen = ScreenEncoder(obs_space["screen_image"].shape, dtype=dtype)
        self.out_features = self.topline.out_features + self.bottomline.out_features + self.screen.out_features
        if cfg.use_prev_action:
            self.num_prev = int(obs_space["prev_actions"].high)
            self.out_features += self.num_prev

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, obs_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
        obs, lead = _flat_obs(obs_dict, self.obs_space)
        tty = obs["tty_chars"]
        if self.cfg.use_tty_only:
            topline = tty[:, 0, :]
            bottom = tty[:, -2:, :].reshape(tty.shape[0], -1)
        else:
            topline = obs["message"]
            bottom = obs["blstats"]
        encodings = [self.topline(topline), self.bottomline(bottom), self.screen(obs["screen_image"])]
        if self.cfg.use_prev_action:
            encodings.append(one_hot(obs["prev_actions"].reshape(-1), self.num_prev, self.dtype))
        x = torch.cat(encodings, dim=-1)
        return x.reshape(tuple(lead) + (x.shape[-1],))


# ------------------------------------------------------------------ ScaledNet


def crop_around_cursor_clamped(maps: torch.Tensor, cursor_rc: torch.Tensor, crop: int) -> torch.Tensor:
    """Batched cursor-centered crop, as `crop_around_cursor_jax` computes it: maps [N, H, W, C],
    cursor_rc [N, 2] (row, col) -> [N, crop, crop, C]. The map is zero-padded by `crop // 2` and
    the window starts at the cursor in padded coordinates, as `lax.dynamic_slice` takes a start:
    a negative start counts from the end (as numpy's indices do), then the start is clamped into
    [0, padded - crop]. So a cursor past the map's edge gives a shifted window, not a padded one,
    and a cursor on the top line (row -1 once the line is cut) gives the window at the map's
    bottom edge."""
    half = crop // 2
    padded = F.pad(maps, (0, 0, half, half, half, half))

    def start(index, size):
        index = index.long()
        return torch.where(index < 0, index + size, index).clamp(0, size - crop)

    rows, cols = start(cursor_rc[:, 0], padded.shape[1]), start(cursor_rc[:, 1], padded.shape[2])
    offsets = torch.arange(crop, device=maps.device)
    r = (rows[:, None] + offsets)[:, :, None]
    c = (cols[:, None] + offsets)[:, None, :]
    n = torch.arange(maps.shape[0], device=maps.device)[:, None, None]
    return padded[n, r, c]


class ScaledResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int, num_layers: int, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"conv{i}", Conv(channels, channels, kernel, 1, dtype=dtype, padding="same"))
            setattr(self, f"norm{i}", GroupNorm(min(8, channels), channels, dtype))

    def forward(self, x):
        out = x
        for i in range(self.num_layers):
            out = F.elu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(out)))
        return out + x


class CharColorEncoderResnet(nn.Module):
    """char+color embeddings of the tty map -> IMPALA conv/resnet trunk."""

    def __init__(self, cfg, map_hw: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.char_embeddings = Embed(NUM_CHARS, cfg.char_edim, dtype)
        self.color_embeddings = Embed(NUM_COLORS, cfg.color_edim, dtype)
        k = cfg.screen_kernel_size
        self.blocks = [(16, k, 2), (32, k, 2), (32, k, 2)][: cfg.screen_conv_blocks]
        height, width = map_hw
        channels = cfg.char_edim + cfg.color_edim
        for bi, (out_ch, kernel, num_res) in enumerate(self.blocks):
            setattr(self, f"down{bi}", Conv(channels, out_ch, kernel, 1, dtype=dtype, padding="same"))
            if not cfg.no_max_pool:
                height, width = (height - 3) // 2 + 1, (width - 3) // 2 + 1
            for ri in range(num_res):
                setattr(self, f"res{bi}_{ri}", ScaledResBlock(out_ch, kernel, 2, dtype))
            channels = out_ch
        self.fc = Dense(height * width * channels, cfg.fc_after_cnn_hdim, dtype=dtype)
        self.out_features = cfg.fc_after_cnn_hdim

    def forward(self, chars, colors):  # [N, H, W] ints
        x = torch.cat([self.char_embeddings(chars), self.color_embeddings(colors)], dim=-1).permute(0, 3, 1, 2)
        for bi, (_, _, num_res) in enumerate(self.blocks):
            x = getattr(self, f"down{bi}")(x)
            if not self.cfg.no_max_pool:
                x = F.max_pool2d(x, 3, 2)
            for ri in range(num_res):
                x = getattr(self, f"res{bi}_{ri}")(x)
        return F.elu(self.fc(_nhwc_flatten(x)))


class ScaledNet(nn.Module):
    CROP_DIM = 9
    CROP_FILTERS = 8
    CROP_INTER_FILTERS = 16
    CROP_LAYERS = 5

    def __init__(self, cfg, obs_space, dtype=torch.float32):
        super().__init__()
        self.cfg, self.obs_space, self.dtype = cfg, obs_space, dtype
        rows, cols = obs_space["tty_chars"].shape
        self.topline = TopLineEncoder(cols, hidden=cfg.msg_hdim, dtype=dtype)
        self.bottomline = BottomLinesEncoder(2 * cols, hidden=cfg.blstats_hdim // 4, dtype=dtype)
        self.screen = CharColorEncoderResnet(cfg, (rows - 3, cols), dtype)
        features = self.topline.out_features + self.bottomline.out_features + self.screen.out_features
        if cfg.use_prev_action:
            self.num_prev = int(obs_space["prev_actions"].high)
            features += self.num_prev
        if cfg.use_crop:
            self.crop_char_embeddings = Embed(NUM_CHARS, cfg.char_edim, dtype)
            self.crop_color_embeddings = Embed(NUM_COLORS, cfg.color_edim, dtype)
            channels = cfg.char_edim + cfg.color_edim
            for i in range(self.CROP_LAYERS):
                out_ch = self.CROP_FILTERS if i == self.CROP_LAYERS - 1 else self.CROP_INTER_FILTERS
                setattr(self, f"crop_conv{i}", Conv(channels, out_ch, 3, 1, dtype=dtype, padding="same"))
                if cfg.use_crop_norm:
                    setattr(self, f"crop_norm{i}", GroupNorm(min(8, out_ch), out_ch, dtype))
                channels = out_ch
            features += self.CROP_DIM * self.CROP_DIM * self.CROP_FILTERS
        self.head_fc0 = Dense(features, cfg.h_dim, dtype=dtype)
        self.head_fc1 = Dense(cfg.h_dim, cfg.h_dim, dtype=dtype)

    def get_out_size(self) -> int:
        return self.cfg.h_dim

    def forward(self, obs_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        obs, lead = _flat_obs(obs_dict, self.obs_space)
        tty_chars, tty_colors = obs["tty_chars"], obs["tty_colors"]
        topline = tty_chars[:, 0, :]
        bottom = tty_chars[:, -2:, :].reshape(tty_chars.shape[0], -1)
        # the map proper: cut the topline and the two status lines
        map_chars = tty_chars[:, 1:-2, :]
        map_colors = tty_colors[:, 1:-2, :]
        encodings = [self.topline(topline), self.bottomline(bottom), self.screen(map_chars, map_colors)]
        if cfg.use_prev_action:
            encodings.append(one_hot(obs["prev_actions"].reshape(-1), self.num_prev, self.dtype))
        if cfg.use_crop:
            # cursor (row, col); -1 row offset because the topline was cut
            cursor = obs["tty_cursor"].long()
            cursor = torch.stack([cursor[:, 0] - 1, cursor[:, 1]], dim=-1)
            crop_x = torch.cat([self.crop_char_embeddings(map_chars), self.crop_color_embeddings(map_colors)], dim=-1)
            crop = crop_around_cursor_clamped(crop_x, cursor, self.CROP_DIM).permute(0, 3, 1, 2)
            for i in range(self.CROP_LAYERS):
                crop = getattr(self, f"crop_conv{i}")(crop)
                if cfg.use_crop_norm:
                    crop = getattr(self, f"crop_norm{i}")(crop)
                crop = F.elu(crop)
            encodings.append(_nhwc_flatten(crop))
        x = torch.cat(encodings, dim=-1)
        for layer in (self.head_fc0, self.head_fc1):
            x = F.relu(layer(x))
        return x.reshape(tuple(lead) + (x.shape[-1],))


MODELS_LOOKUP = {
    "ChaoticDwarvenGPT5": ChaoticDwarvenGPT5,
    "ScaledNet": ScaledNet,
}


def make_nethack_encoder(cfg, obs_space) -> nn.Module:
    try:
        model_cls = MODELS_LOOKUP[cfg.model]
    except KeyError:
        raise NotImplementedError(f"model={cfg.model}") from None
    return model_cls(cfg, obs_space, dtype=default_compute_dtype(cfg))
