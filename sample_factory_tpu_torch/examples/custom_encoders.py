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

- `VizdoomEncoder`: counterpart of `sf_examples_tpu/vizdoom/doom_model.py` (the image encoder
  over `obs`, a 2-layer 128-wide MLP over `measurements`, concatenated).
- `InstructionEncoder` and `DmlabEncoder`: counterpart of `sf_examples_tpu/dmlab/dmlab_model.py`
  (the image encoder ++ a 64-unit LSTM over the 16 instruction tokens). The LSTM's sequence
  mode is the LSTM kernel on the card.

These two take the compute dtype of the cfg, as their flax modules do, and keep flax's names:
the image encoder is `encoders.enc_obs`, the instruction encoder `encoders.enc_instr` with its
`embed.0` (flax `Embed_0`) and `fused_lstm.0` (`FusedLSTMCell_0`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sample_factory_tpu_torch.models.encoder import dense_stack, make_img_encoder
from sample_factory_tpu_torch.models.model_utils import Conv, Dense, default_compute_dtype, nonlinearity
from sample_factory_tpu_torch.ops.rnn_cells import FusedLSTMCell

DMLAB_INSTRUCTIONS = "INSTR"  # the obs key of `examples/dmlab/dmlab30.py`
DMLAB_VOCABULARY_SIZE = 1000
INSTRUCTION_EMBED_DIM = 20
INSTRUCTION_LSTM_UNITS = 64


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


class VizdoomEncoder(nn.Module):
    """The image encoder over `obs`, and where the obs has `measurements`, two Denses of 128 with
    the cfg's nonlinearity over them; [image features, measurement features]."""

    def __init__(self, cfg, obs_space):
        super().__init__()
        self.dtype = default_compute_dtype(cfg)
        self.act = nonlinearity(cfg)
        self.encoders = nn.ModuleDict({"enc_obs": make_img_encoder(cfg, obs_space["obs"].shape, self.dtype)})
        self.out_features = self.encoders["enc_obs"].out_features
        self.has_measurements = "measurements" in obs_space.keys()
        if self.has_measurements:
            self.measurements_fc0 = Dense(obs_space["measurements"].shape[0], 128, dtype=self.dtype)
            self.measurements_fc1 = Dense(128, 128, dtype=self.dtype)
            self.out_features += 128

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, obs_dict):
        x = self.encoders["enc_obs"](obs_dict["obs"])
        if self.has_measurements:
            m = obs_dict["measurements"].to(self.dtype)
            for layer in (self.measurements_fc0, self.measurements_fc1):
                m = self.act(layer(m))
            x = torch.cat([x, m.to(x.dtype)], dim=-1)
        return x


class Embed(nn.Module):
    """flax's `nn.Embed`: a float32 table [num, features] read in `dtype`."""

    flax_weight_name = "embedding"

    def __init__(self, num: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.weight.shape[1]), generator=generator)  # flax's default

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight.to(self.dtype))


class InstructionEncoder(nn.Module):
    """Token ids [..., L] -> the LSTM's output [..., 64] at the last non-padding step.

    As the flax module: the padding id 0 is zeroed by the mask (flax's row 0 is a trained row like
    any other, so `nn.Embedding(padding_idx=0)` would differ), the LSTM runs all L steps from a zero
    state without resets, and the output is read at index max(count of non-zero ids, 1) - 1."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.ModuleList([Embed(DMLAB_VOCABULARY_SIZE, INSTRUCTION_EMBED_DIM, dtype)])
        self.fused_lstm = nn.ModuleList([FusedLSTMCell(INSTRUCTION_EMBED_DIM, INSTRUCTION_LSTM_UNITS, dtype=dtype)])
        self.out_features = INSTRUCTION_LSTM_UNITS

    def forward(self, tokens):
        lead, L = tokens.shape[:-1], tokens.shape[-1]
        tokens = tokens.reshape(-1, L)
        B = tokens.shape[0]
        valid = tokens != 0
        embed = self.embed[0](tokens) * valid.to(self.dtype)[..., None]
        lengths = valid.sum(dim=1).clamp(min=1)
        h0 = torch.zeros((B, 2 * INSTRUCTION_LSTM_UNITS), dtype=torch.float32, device=tokens.device)
        no_resets = torch.zeros((L, B), dtype=torch.float32, device=tokens.device)
        outputs, _ = self.fused_lstm[0](embed.transpose(0, 1), h0, resets=no_resets, seq=True)  # [L, B, H]
        last = outputs[lengths - 1, torch.arange(B, device=tokens.device)].to(self.dtype)
        return last.reshape(lead + (INSTRUCTION_LSTM_UNITS,))


class DmlabEncoder(nn.Module):
    """The image encoder over `obs` ++ the instruction encoder over `INSTR` where the obs has it.
    Leading dims are any ([B] in a rollout, [S, R] in the learner): the flax class unpacks the
    tokens' shape into (B, L) and refuses the learner's [S, R, L]."""

    def __init__(self, cfg, obs_space):
        super().__init__()
        dtype = default_compute_dtype(cfg)
        self.encoders = nn.ModuleDict({"enc_obs": make_img_encoder(cfg, obs_space["obs"].shape, dtype)})
        self.out_features = self.encoders["enc_obs"].out_features
        self.has_instructions = DMLAB_INSTRUCTIONS in obs_space.keys()
        if self.has_instructions:
            self.encoders["enc_instr"] = InstructionEncoder(dtype)
            self.out_features += INSTRUCTION_LSTM_UNITS

    def get_out_size(self) -> int:
        return self.out_features

    def forward(self, obs_dict):
        x = self.encoders["enc_obs"](obs_dict["obs"])
        if self.has_instructions:
            instr = self.encoders["enc_instr"](obs_dict[DMLAB_INSTRUCTIONS])
            x = torch.cat([x, instr.to(x.dtype)], dim=-1)
        return x
