"""GRU/LSTM cells with a step mode and a fused sequence mode.

Counterpart of `sample_factory_tpu/ops/rnn_cells.py`. Parameters keep the JAX
layout (`wi [in, G*H]`, `wh [H, G*H]`, `bi`, and `bh` for the GRU), so that
`bridge.py` carries them over unchanged.

  cell(x, h)                            - one step (rollout / inference), plain torch
  cell(x_seq, h0, resets=r, seq=True)   - BPTT over [T, B]: the input projection of
                                          all T steps is one matmul, the recurrence
                                          runs in `ops/cuda_rnn.py` (the Hopper kernel
                                          on the card, its plain version on the CPU)

Step mode uses `torch.sigmoid` like the JAX cells (`jax.nn.sigmoid`); sequence
mode uses the kernels' `1 / (1 + exp(-x))`. The two agree in float32 and round
differently in bfloat16, as the JAX package's scan and Pallas paths do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sample_factory_tpu_torch.models.model_utils import kernel_init_
from sample_factory_tpu_torch.ops.cuda_rnn import gru_seq, lstm_seq


class FusedGRUCell(nn.Module):
    """GRU with gate layout [r, z, n] (cuDNN placement of the reset gate)."""

    def __init__(self, input_size: int, hidden_size: int, cfg=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype, self.hidden_size = cfg, dtype, hidden_size
        G = 3 * hidden_size
        self.wi = nn.Parameter(torch.empty(input_size, G))
        self.wh = nn.Parameter(torch.empty(hidden_size, G))
        self.bi = nn.Parameter(torch.empty(G))
        self.bh = nn.Parameter(torch.empty(G))

    def reset_parameters(self, generator=None) -> None:
        kernel_init_(self.wi.data, self.cfg, self.wi.shape[0], generator)
        nn.init.orthogonal_(self.wh.data, generator=generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bh)

    @staticmethod
    def _gates(x_proj, h_proj, h):
        xr, xz, xn = x_proj.chunk(3, dim=-1)
        hr, hz, hn = h_proj.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h

    def forward(self, x, h, resets: Optional[torch.Tensor] = None, seq: bool = False):
        dt = self.dtype
        wi, wh, bi, bh = self.wi.to(dt), self.wh.to(dt), self.bi.to(dt), self.bh.to(dt)
        if not seq:
            h_in = h.to(dt)
            new_h = self._gates(x.to(dt) @ wi + bi, h_in @ wh + bh, h_in).float()
            return new_h, new_h
        # x [T, B, D], h [B, H], resets [T, B]
        x_proj_seq = x.to(dt) @ wi + bi
        return gru_seq(x_proj_seq.contiguous(), h.contiguous(), resets.float().contiguous(), wh, bh)


class FusedLSTMCell(nn.Module):
    """LSTM with gate layout [i, f, g, o], forget bias 1.0, no recurrent bias. State = concat[h, c]."""

    def __init__(self, input_size: int, hidden_size: int, cfg=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype, self.hidden_size = cfg, dtype, hidden_size
        G = 4 * hidden_size
        self.wi = nn.Parameter(torch.empty(input_size, G))
        self.wh = nn.Parameter(torch.empty(hidden_size, G))
        self.bi = nn.Parameter(torch.empty(G))

    def reset_parameters(self, generator=None) -> None:
        kernel_init_(self.wi.data, self.cfg, self.wi.shape[0], generator)
        nn.init.orthogonal_(self.wh.data, generator=generator)
        nn.init.zeros_(self.bi)

    @staticmethod
    def _gates(proj, c):
        i, f, g, o = proj.chunk(4, dim=-1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, new_c

    def forward(self, x, hc, resets: Optional[torch.Tensor] = None, seq: bool = False):
        H, dt = self.hidden_size, self.dtype
        wi, wh, bi = self.wi.to(dt), self.wh.to(dt), self.bi.to(dt)
        if not seq:
            h, c = hc[:, :H], hc[:, H:]
            proj = x.to(dt) @ wi + h.to(dt) @ wh + bi
            new_h, new_c = self._gates(proj, c.to(dt))
            new_h, new_c = new_h.float(), new_c.float()
            return new_h, torch.cat([new_h, new_c], dim=-1)
        x_proj_seq = x.to(dt) @ wi + bi
        return lstm_seq(x_proj_seq.contiguous(), hc.contiguous(), resets.float().contiguous(), wh)
