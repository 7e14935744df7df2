"""GRU/LSTM recurrences over one BPTT segment: Hopper kernels and their plain versions.

The learner's recurrent core runs [T, B] segments with a sequential dependence
on T (`ops/rnn_cells.py`). The input projection of all T steps is one matmul
outside this module; what remains per step is a [B, H] x [H, G*H] product plus
the gates. That recurrence is the only hand-written kernel on the training path.

Kernels (CUDA C++, `csrc/rnn_seq.cu`, built for sm_90a at first use):

- `gru_seq` replaces the Pallas kernel `_gru_kernel` / `pallas_gru_seq` of
  `sample_factory_tpu/ops/pallas_gru.py` (:78-109, :177-197);
- `lstm_seq` replaces `_lstm_kernel` / `pallas_lstm_seq` (:226-253, :299-318).

Bound on the H100: HBM bytes (x_proj in, outs out: ~43 MB at T=32, B=512,
H=256 in bf16, against ~6.4 GFLOP of products); in practice the chain of T
dependent steps sets the time. `launch_plan` picks one of three designs from the
shape and the card's spec (`card_spec`: its SMs, the clusters it runs at once, a
block's shared memory; see the source note in `csrc/rnn_seq.cu`):

- "cluster": the gate columns of `wh` are split across the blocks of a
  thread-block cluster, each block keeps its slice in shared memory for all T
  steps and the new carry is exchanged through distributed shared memory, one
  cluster barrier per step; bf16 products on the tensor cores. The wrapper
  repacks `wh` into per-block slices (`pack_wh`, one gather per call);
- "grid" (float32 GRU and LSTM where no cluster slice fits: H=512 on the Doom,
  NetHack and AllegroHandLSTM learners, `tp`'s multichip leg and the default
  configuration): one persistent cooperative launch of Q batch tiles x S unit
  slices (`grid_plan`, at most one block an SM), each block keeping the gate columns of its U hidden
  units in shared memory for all T steps (the GRU's three gates padded to the
  LSTM's four); only h crosses blocks, through a global double buffer in L2,
  one grid barrier a step. f32 FMAs on the CUDA cores (TF32 would break the
  f32 tolerance), which bound it at large B (2*B*H*G*H operations a step at 67
  TFLOP/s); a step's barrier and L2 round trip bound it at small B;
- "resident" (the LSTM at a small width, `ROWS_OVER_WAVES_MAX_H`, wherever a
  cluster slice fits and `resident_plan` gives a plan: DMLab's instruction
  encoder in a rollout slot, (16, 64, 64) f32, over the last observations,
  (16, 128, 64), and over a learner minibatch, (16, 1024, 64)): all
  of `wh` (64 KB in f32 at H=64) in one block's shared memory for all T steps; a
  block owns `resident_plan`'s rows and all H units, so no block waits on
  another; one block barrier a step;
- "rows": the first design, for shapes whose slice does not fit a block even
  at 16 blocks per cluster, or whose width per block is no power of two, and
  that the grid design does not take (bf16 at H=1024, H=100), and for the GRU at
  a small width where the cluster plan would need more than one wave: one block
  per 4 batch rows, `wh` re-read from L2.

Gradients: each kernel sits in a `torch.autograd.Function`. The forward also
saves its outputs, from which the backward knows the carry entering every step
(h0, then the step before's output, zero after a reset). On a CUDA tensor the
backward is a prologue in plain PyTorch (the carries and their projection, one
product over T*B rows), one hand-written reverse-time kernel (it replaces `_bwd`
and `_lstm_bwd` of `pallas_gru.py` (:189-195, :311-315), which take `jax.vjp` of
the scan and which XLA compiles into one reverse loop) and an epilogue (d_wh,
products over T*B rows). `bwd_plan` picks its design from the shape, the dtype
and the card's spec:

- "grid" (`gru_seq_grid_bwd`, `lstm_seq_grid_bwd`: `csrc/rnn_seq.cu:seq_bwd_grid_kernel`),
  exactly where the forward takes its grid design (float32, H a multiple of 64,
  no cluster slice: the five float32 H=512 learner sites): a persistent
  cooperative launch of batch tiles x unit slices (`bwd_grid_plan`), each block
  keeping wh's rows of its units in shared memory for all T steps; the gate
  cotangents, which the kernel writes as d_x_proj (and the GRU's d_hn) anyway,
  cross blocks through L2 under one grid barrier a step;
- "cluster" (`gru_seq_cluster_bwd`, `lstm_seq_cluster_bwd`:
  `seq_bwd_cluster_kernel`, the forward's cluster design mirrored), exactly where
  the forward takes its cluster design (bf16, float32 at H <= 256), with the
  forward's cluster and unit slice (`bwd_cluster_plan`): each block keeps the
  forward's slice of wh in shared memory for all T steps, multiplies its units'
  gate cotangents by it and sends each peer the columns of that peer's units
  through distributed shared memory, one cluster barrier a step; bf16 on the
  tensor cores (the f32 gate cotangents in two bf16 parts), f32 on the CUDA cores;
- "resident" (`lstm_seq_resident_bwd`: `lstm_resident_bwd_kernel`), exactly
  where the forward takes its resident design: the forward's blocks, with wh kept
  in shared memory for all T steps, its rows padded by 16 bytes;
- "rows" (`gru_seq_bwd`, `lstm_seq_bwd`: `seq_bwd_kernel`, the row design
  mirrored) everywhere else (bf16 at H=1024, H=100, and the GRU at a small width
  where the forward's cluster plan needs several waves): a block owns `bwd_rows`
  batch rows and all H units and re-reads wh^T from L2 every step.

The LSTM from its raw input, `lstm_seq_in(x, wi, bi, hc0, resets, wh)` (what `FusedLSTMCell(seq=True)`
calls without a model axis), takes the input product into the kernel where the forward takes the
resident design (`resident_in_plan`: DMLab's instruction encoder, I=20, at all three of its sites), so
that its route is one launch each way, as cuDNN's LSTM call is: `lstm_seq_resident_in`
(`csrc/rnn_seq.cu:lstm_resident_in_kernel`: x read at its strides, wi and wh laid out in shared memory
by the block, each step's input part made by producer warps beside the recurrence) writes, where a
gradient is needed, the
gate pre-activations, the cell state entering each step and xh = [x | the carry h | 1 | 0 ...];
`lstm_seq_resident_in_bwd` (the resident backward kernel on those buffers, its cell-state pass skipped)
gives d_x_proj, and two products give the rest: xh^T @ d_x_proj (the gradients of wi, wh and bi in one)
and d_x_proj @ wi^T. Elsewhere `lstm_seq_in` is the Linear, then `lstm_seq`; on the CPU its plain version.

There is no fallback between them: the plan decides before the launch, and a
refused launch raises. On a CPU tensor the backward reruns the plain version
under autograd (`_recompute_grads`), the direct counterpart of `_bwd`.
`gru_seq_bwd_reference` and `lstm_seq_bwd_reference` are the recurrence's plain
versions, of both designs. `resets` get no gradient.

Dispatch: a CUDA tensor launches the planned kernel or raises; a CPU tensor
runs the plain version. `launch_counts()` counts the launches of each kernel,
per design ("gru_seq" is the cluster design, "gru_seq_rows" the row design,
"gru_seq_grid" the grid design; "gru_seq_bwd", "gru_seq_grid_bwd" and
"gru_seq_cluster_bwd" the backward's row, grid and cluster designs;
"lstm_seq_resident" and "lstm_seq_resident_bwd" the LSTM's resident design;
"lstm_seq_resident_in" and "lstm_seq_resident_in_bwd" `lstm_seq_in`'s fused pair).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "rnn_seq.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the row design's shared memory, 3 * 4 rows * H * 4 bytes (LSTM), reaches 48 KB, the most a
# launch takes without raising the dynamic shared-memory limit, at H = 1024
MAX_HIDDEN = 1024
GRID_WIDE_ROWS = 1024  # from this batch on, the grid design takes 8 x 8 register tiles and 16 units a block
ROW_TILE = 4  # batch rows per block in the row design (kTile in csrc/rnn_seq.cu)
# at this width and below the LSTM takes the resident design, and the GRU the row design where its cluster plan needs more
# than one wave (the DMLab instruction encoder's LSTM-64 over a minibatch, (16, 1024, 64) f32: 32 clusters of 8 in three
# waves; launch_plan has the measurements)
ROWS_OVER_WAVES_MAX_H = 64
RESIDENT_MAX_THREADS = 512  # most threads of a resident block (kResidentThreads in csrc/rnn_seq.cu)
RESIDENT_MIN_THREADS = 128  # the 4 warps a resident block gets where its rows allow (kResidentMinThreads)
BWD_MAX_ROWS = 8  # most batch rows a backward block owns in the row design (the kernel is built for 1, 2, 4 and 8)
BWD_GRID_MAX_THREADS = 512  # most threads of a grid backward block (kBwdGridThreads in csrc/rnn_seq.cu)

_lib = None
_lib_lock = threading.Lock()


# ------------------------------------------------------------------ plain versions


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with each op in x's dtype: the kernels' form (and the Pallas
    kernels', `pallas_gru.py:70-75`); torch.sigmoid rounds differently in bf16. x is held
    at -88 and above, where exp(-x) is finite: below, the gate is 0 to within 7e-39 and its
    gradient 0, where exp's overflow would make it 0 * inf = NaN (the CPU's backward reruns this
    version; the backward kernel and `_sigmoid_bwd` give the same 0)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x.clamp(min=-88.0)))


def gru_seq_reference(x_proj, h0, resets, wh, bh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_proj [T,B,3H], h0 [B,H] f32, resets [T,B] f32, wh [H,3H], bh [3H])
    -> (outs [T,B,H] f32, h_final [B,H] f32). Gate math in x_proj's dtype."""
    dtype = x_proj.dtype
    one = torch.ones((), dtype=dtype, device=x_proj.device)
    h = h0
    outs = []
    for t in range(x_proj.shape[0]):
        h_in = h.to(dtype)
        h_proj = h_in @ wh + bh
        xr, xz, xn = x_proj[t].chunk(3, dim=-1)
        hr, hz, hn = h_proj.chunk(3, dim=-1)
        r = _sigmoid(xr + hr)
        z = _sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        new_h = ((one - z) * n + z * h_in).float()
        outs.append(new_h)
        h = torch.where(resets[t, :, None] > 0, torch.zeros_like(new_h), new_h)
    return torch.stack(outs), h


def lstm_seq_reference(x_proj, hc0, resets, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_proj [T,B,4H] incl. bi, hc0 [B,2H] f32, resets [T,B] f32, wh [H,4H])
    -> (outs [T,B,H] f32, hc_final [B,2H] f32). Gates [i,f,g,o], forget bias 1."""
    dtype = x_proj.dtype
    H = hc0.shape[-1] // 2
    one = torch.ones((), dtype=dtype, device=x_proj.device)
    hc = hc0
    outs = []
    for t in range(x_proj.shape[0]):
        h, c = hc[:, :H], hc[:, H:]
        proj = x_proj[t] + h.to(dtype) @ wh
        i, f, g, o = proj.chunk(4, dim=-1)
        new_c = _sigmoid(f + one) * c.to(dtype) + _sigmoid(i) * torch.tanh(g)
        new_h = _sigmoid(o) * torch.tanh(new_c)
        new_hc = torch.cat([new_h, new_c], dim=-1).float()
        outs.append(new_h.float())
        hc = torch.where(resets[t, :, None] > 0, torch.zeros_like(new_hc), new_hc)
    return torch.stack(outs), hc


def lstm_seq_in_reference(x, wi, bi, hc0, resets, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lstm_seq_in`'s plain version: x [T,B,I] @ wi [I,4H] + bi [4H] in x's dtype (the Linear of the unfused route: the
    product rounded to the dtype, then the add), then lstm_seq_reference."""
    return lstm_seq_reference(x @ wi + bi, hc0, resets, wh)


def lstm_seq_in_saved_reference(x, wi, bi, hc0, resets, wh):
    """The plain version of `lstm_seq_in`'s kernel with the backward's buffers it writes where a gradient is needed:
    -> (outs, hc_final as lstm_seq_in_reference; proj [T,B,4H] = x_proj + the carry's h @ wh in x's dtype; cells [T,B,H] f32,
    the cell state entering each step; xh [T,B,K] = [x | the carry's h entering each step | 1 | 0 ...] in x's dtype, K =
    in_width(I, H))."""
    dtype = x.dtype
    T, B, I = x.shape
    H = hc0.shape[-1] // 2
    x_proj = x @ wi + bi
    one = torch.ones((), dtype=dtype, device=x.device)
    hc, outs, proj, cells, carries = hc0, [], [], [], []
    for t in range(T):
        h, c = hc[:, :H].to(dtype), hc[:, H:].to(dtype)
        carries.append(h)
        cells.append(c.float())
        proj.append(x_proj[t] + h @ wh)
        i, f, g, o = proj[-1].chunk(4, dim=-1)
        new_c = _sigmoid(f + one) * c + _sigmoid(i) * torch.tanh(g)
        new_h = _sigmoid(o) * torch.tanh(new_c)
        new_hc = torch.cat([new_h, new_c], dim=-1).float()
        outs.append(new_h.float())
        hc = torch.where(resets[t, :, None] > 0, torch.zeros_like(new_hc), new_hc)
    constant = torch.zeros((T, B, in_width(I, H) - I - H), dtype=dtype, device=x.device)
    constant[..., 0] = 1
    xh = torch.cat([x, torch.stack(carries), constant], dim=-1)
    return torch.stack(outs), hc, torch.stack(proj), torch.stack(cells), xh


def _sigmoid_bwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate as `_sigmoid` computes it (in x's dtype) and its derivative in f32, e * s * s with
    e = exp(-x): 0 below -88, as the clamp's backward gives it."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    e = torch.exp(-x.clamp(min=-88.0))
    s = one / (one + e)
    return s, torch.where(x < -88.0, 0.0, e.float() * s.float() * s.float())


def gru_seq_bwd_reference(d_outs, d_h_final, resets, x_proj, h_proj, h_prev, wh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GRU backward's recurrence, plain (the kernel `gru_seq_bwd`'s signature): a reverse loop over T in
    f32 arithmetic, the gates recomputed in x_proj's dtype as the forward rounds them.
    (d_outs [T,B,H] f32, d_h_final [B,H] f32, resets [T,B] f32, x_proj [T,B,3H], h_proj [T,B,3H] = the carry
    entering each step @ wh + bh, h_prev [T,B,H] f32 = that carry, wh [H,3H])
    -> (d_x_proj [T,B,3H], d_hn [T,B,H] = da_n * r, both in x_proj's dtype; d_h0 [B,H] f32). The cotangent of
    h_proj is [da_r, da_z, d_hn]: its r and z columns are d_x_proj's."""
    dtype = x_proj.dtype
    wt = wh.float().t()
    dh = d_h_final.float()
    d_x, d_hn = [], []
    for t in reversed(range(x_proj.shape[0])):
        xr, xz, xn = x_proj[t].chunk(3, dim=-1)
        hr, hz, hn = h_proj[t].chunk(3, dim=-1)
        r, dr = _sigmoid_bwd(xr + hr)
        z, dz = _sigmoid_bwd(xz + hz)
        n = torch.tanh(xn + r * hn).float()
        r, z, hn, h = r.float(), z.float(), hn.float(), h_prev[t].to(dtype).float()
        g = d_outs[t] + torch.where(resets[t, :, None] > 0, 0.0, dh)  # the carry's cotangent stops at a reset
        dan = g * (1.0 - z) * (1.0 - n * n)
        dar, daz = dan * hn * dr, g * (h - n) * dz
        d_x.append(torch.cat([dar, daz, dan], dim=-1))
        d_hn.append(dan * r)
        dh = g * z + torch.cat([dar, daz, d_hn[-1]], dim=-1) @ wt
    return torch.stack(d_x[::-1]).to(dtype), torch.stack(d_hn[::-1]).to(dtype), dh


def lstm_seq_bwd_reference(d_outs, d_hc_final, resets, proj, hc0, wh, cells=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM backward's recurrence, plain (the kernel `lstm_seq_bwd`'s signature): the cell state entering
    each step forward in time, in proj's dtype as the forward computes it (the forward saves h, not c), then
    a reverse loop over T in f32 arithmetic.
    (d_outs [T,B,H] f32, d_hc_final [B,2H] f32 or None (zero), resets [T,B] f32, proj [T,B,4H] = x_proj + the carry's h @ wh,
    hc0 [B,2H] f32, wh [H,4H]; `cells` [T,B,H] f32: the cell states entering each step where a forward saved them, read in
    place of the pass) -> (d_x_proj [T,B,4H] in proj's dtype, also the product's gradient; d_hc0 [B,2H] f32)."""
    dtype = proj.dtype
    H = hc0.shape[-1] // 2
    one = torch.ones((), dtype=dtype, device=proj.device)
    if cells is not None:
        cells = cells.to(dtype)
    else:
        c, cells = hc0[:, H:].to(dtype), []
        for t in range(proj.shape[0]):
            cells.append(c)
            i, f, g, _ = proj[t].chunk(4, dim=-1)
            new_c = _sigmoid(f + one) * c + _sigmoid(i) * torch.tanh(g)
            c = torch.where(resets[t, :, None] > 0, torch.zeros_like(new_c), new_c)
    wt = wh.float().t()
    if d_hc_final is None:
        d_hc_final = torch.zeros_like(hc0)
    dh, dc = d_hc_final[:, :H].float(), d_hc_final[:, H:].float()
    d_x = []
    for t in reversed(range(proj.shape[0])):
        i, f, g, o = proj[t].chunk(4, dim=-1)
        (si, dsi), (sf, dsf), (so, dso) = _sigmoid_bwd(i), _sigmoid_bwd(f + one), _sigmoid_bwd(o)
        tg = torch.tanh(g)
        tc = torch.tanh(sf * cells[t] + si * tg).float()
        si, sf, so, tg, c = si.float(), sf.float(), so.float(), tg.float(), cells[t].float()
        reset = resets[t, :, None] > 0
        gh, gc = d_outs[t] + torch.where(reset, 0.0, dh), torch.where(reset, 0.0, dc)
        dct = gc + gh * so * (1.0 - tc * tc)
        d_x.append(torch.cat([dct * tg * dsi, dct * c * dsf, dct * si * (1.0 - tg * tg), gh * tc * dso], dim=-1))
        dc = dct * sf
        dh = d_x[-1] @ wt
    return torch.stack(d_x[::-1]).to(dtype), torch.cat([dh, dc], dim=-1)


# ------------------------------------------------------------------ launch plan


@dataclass(frozen=True)
class Plan:
    """How one call is laid out on the card. A "cluster" launch has `grid` blocks in clusters of
    `cluster`; each cluster owns `rows` batch rows and each of its blocks `units` hidden units.
    A "grid" launch has `grid` blocks, `grid // cluster` batch tiles of `rows` rows times `cluster`
    unit slices of `units` units (block = tile * cluster + slice), `threads` threads each with
    `tile_rows` x `tile_cols` accumulators, K split `ksplit` ways and streamed in chunks of `kchunk`,
    the block's rows covered in `passes` passes.
    A "rows" launch has one block per `rows` batch rows, each owning all `units` = H units; so does a "resident" launch,
    whose `threads` threads each own one unit of `tile_rows` of the block's rows."""

    design: str  # "cluster", "grid", "resident" or "rows"
    cluster: int  # blocks per cluster; unit slices in the grid design (1 in the row design)
    rows: int  # batch rows per cluster (per block in the grid and row designs)
    units: int  # hidden units per block
    smem: int  # dynamic shared memory per block, bytes
    grid: int  # blocks
    tile_rows: int = 0  # grid design: a thread's register tile, batch rows ... (resident design: a thread's rows)
    tile_cols: int = 0  # ... x gate columns (tile_cols / 4 units, 4 gates each)
    ksplit: int = 1  # grid design: threads that share one register tile's K range
    kchunk: int = 0  # grid design: K columns of h in shared memory at a time (H: all of them)
    passes: int = 1  # grid design: passes of the block's threads over its rows
    threads: int = 0  # grid and resident designs: threads per block
    buffers: int = 0  # the backward's cluster design: receive buffers of the partial products (2: one cluster barrier a step)


def _gates(kind: str) -> int:
    return {"gru": 3, "lstm": 4}[kind]


def cluster_smem(kind: str, H: int, cluster: int, rows: int, itemsize: int) -> int:
    """Shared memory of one cluster-design block (`cluster_smem_bytes` in csrc/rnn_seq.cu):
    the wh slice [G*U][H+pad], the carry [2][rows][H+pad] and x_proj [2][rows][G*U] in the
    input type; the product [rows][G*U] (twice in f32: two halves of K), bh (GRU) or the cell
    state (LSTM), and resets [2][rows] in f32."""
    G, U = _gates(kind), H // cluster
    N, HS = G * U, H + 16 // itemsize
    partials = 2 if itemsize == 4 else 1
    return itemsize * (N * HS + 2 * rows * HS + 2 * rows * N) + 4 * (partials * rows * N + (N if kind == "gru" else rows * U) + 2 * rows)


def grid_max_threads(tile_rows: int, tile_cols: int) -> int:
    """Most threads of a grid-design block (`grid_max_threads` in csrc/rnn_seq.cu): 512 with 16
    accumulators a thread, 256 with 64, where a thread needs more than 128 registers."""
    return 256 if tile_rows * tile_cols >= 64 else 512


def grid_threads(units: int, rows: int, tile_rows: int, tile_cols: int, ksplit: int, passes: int = 1) -> int:
    """Threads of a grid-design block: `ksplit` x the row tiles of one pass x column tiles
    (`grid_threads` in csrc/rnn_seq.cu)."""
    return ksplit * (rows // passes // tile_rows) * (4 * units // tile_cols)


def grid_smem(H: int, units: int, rows: int, tile_rows: int, tile_cols: int, ksplit: int, kchunk: int, passes: int = 1) -> int:
    """Shared memory of one grid-design block (`grid_smem_bytes` in csrc/rnn_seq.cu), all f32: the
    wh slice [H][4U] (the GRU's three gates and a fourth of zeros), a pass's h chunks
    [stages][rows / passes][kchunk + 4] (one stage when the chunk is all of H, else two), and where K
    is split, every thread's partial sums [threads][tile_rows * tile_cols]."""
    stages = 1 if kchunk == H else 2
    threads = grid_threads(units, rows, tile_rows, tile_cols, ksplit, passes)
    partials = threads * tile_rows * tile_cols if ksplit > 1 else 0
    return 4 * (H * 4 * units + stages * (rows // passes) * (kchunk + 4) + partials)


@dataclass(frozen=True)
class CardSpec:
    """What the launch plan reads of a card: its SMs, the clusters of 8 and of 16 blocks that it runs
    at once with one block an SM (cudaOccupancyMaxActiveClusters; a cluster lives in one GPC, so
    these depend on the card's GPC layout, not only on its SM count), and the shared memory one block
    may take (the opt-in limit)."""

    sms: int
    clusters_of_8: int
    clusters_of_16: int
    smem_limit: int

    def clusters_at_once(self, size: int) -> int:
        return {8: self.clusters_of_8, 16: self.clusters_of_16}[size]


# the H100 SXM's values, which card_spec reads there: 15 x 8 = 120 of its 132 SMs in clusters of 8,
# and 227 KB a block; what a caller gets that names no card (tests, CPU callers)
H100_SXM = CardSpec(sms=132, clusters_of_8=15, clusters_of_16=7, smem_limit=232_448)


def card_spec(device) -> CardSpec:
    """The spec of the CUDA card `device` (a torch.device, an index, or "cuda"), read once per
    device index and process."""
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"card_spec needs a CUDA device, got {device}")
    return _card_spec(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _card_spec(index: int) -> CardSpec:
    props = torch.cuda.get_device_properties(index)
    smem = props.shared_memory_per_block_optin
    lib = load_library()
    with torch.cuda.device(index):  # a block of the opt-in limit holds its SM alone: one block an SM
        clusters = {size: lib.max_active_clusters(4, 0, size, smem) for size in (8, 16)}
    return CardSpec(props.multi_processor_count, clusters[8], clusters[16], smem)


# K splits and passes a grid-design block may take, in the order tried
GRID_SPLITS = ((8, 1), (4, 1), (1, 1), (1, 2), (1, 4))


@functools.lru_cache(maxsize=256)
def grid_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM):
    """The grid design's plan for the float32 GRU or LSTM on a card of `spec`, or None where it takes
    none. Both kinds get the same plan: the kernel pads the GRU's three gates to four gate columns.

    Below GRID_WIDE_ROWS batch rows 4 x 4 register tiles and slices of 4, 8 or 16 units (in that
    order: at H = 512 on the H100 SXM, 128 slices of 4 units in one batch tile share each step's
    product); from there on 8 x 8 tiles and slices of 16, then 8 units (wider slices mean fewer reads
    of h from L2). One block an SM, so slices x batch tiles <= spec.sms. Each slice width whose slices
    fit, and each K split and pass count of GRID_SPLITS, gives a candidate: the fewest rows per tile,
    a multiple of passes x tile height, that fill the SMs with tiles; it fits where its threads stay
    within `grid_max_threads`, where K is split each cell has a thread of its own (the kernel's split
    path applies one cell a thread), and the widest K chunk of at most 128 gives a block's shared
    memory within spec.smem_limit (two stages: the next chunk loads while this one is multiplied).
    The plan is the candidate with the most blocks; among equals, one whose rows needed no rounding up
    to the pass count, then the first in order (so the plans of the fewest rows in steps of the tile
    height, which this search made before it stepped by passes, keep their place)."""
    del kind  # the same plan for both
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype != torch.float32 or H % 64:
        return None
    tm, tn = (8, 8) if B >= GRID_WIDE_ROWS else (4, 4)
    best, best_key = None, None
    for units in ((16, 8) if tn == 8 else (4, 8, 16)):
        slices = H // units
        if slices > spec.sms:
            continue
        most = min(spec.sms // slices, -(-B // tm))  # batch tiles that the SMs hold
        fewest = -(-B // (most * tm)) * tm
        for ksplit, passes in GRID_SPLITS:
            step = passes * tm
            rows = -(-B // (most * step)) * step
            threads = grid_threads(units, rows, tm, tn, ksplit, passes)
            if threads > grid_max_threads(tm, tn) or (ksplit > 1 and rows * units > threads):
                continue
            for kchunk in (128, 64, 32, 16):
                if H % kchunk or kchunk % (4 * ksplit):
                    continue
                smem = grid_smem(H, units, rows, tm, tn, ksplit, kchunk, passes)
                if smem <= spec.smem_limit:
                    tiles = -(-B // rows)
                    key = (tiles * slices, rows == fewest)
                    if best is None or key > best_key:
                        best, best_key = Plan("grid", slices, rows, units, smem, tiles * slices, tm, tn, ksplit, kchunk, passes, threads), key
                    break
    return best


@functools.lru_cache(maxsize=256)
def cluster_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM):
    """The cluster design's plan on a card of `spec`, or None where no slice fits. 8 blocks per cluster,
    else 16 (a non-portable cluster size on the H100), never a size of which the card runs no cluster
    at once; the hidden units of a block are a power of two, at least 8 (the mma's n8, 16-byte copies,
    and index arithmetic by shifts). Rows per cluster: the fewest that let all clusters run in one wave
    (spec.clusters_at_once), in steps of the product's row granularity (16 for bf16's m16 tiles, 8 for
    f32), at most 64 / 32, lowered until the block's shared memory fits; above that many clusters of
    64 / 32 rows the clusters run in waves."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    itemsize = 2 if dtype == torch.bfloat16 else 4
    step, cap = (16, 64) if itemsize == 2 else (8, 32)
    for cluster in (8, 16):
        units = H // cluster
        if H % cluster or units < 8 or units & (units - 1) or spec.clusters_at_once(cluster) < 1:
            continue
        want = -(-B // spec.clusters_at_once(cluster))
        for rows in range(min(cap, max(step, -(-want // step) * step)), 0, -step):
            smem = cluster_smem(kind, H, cluster, rows, itemsize)
            if smem <= spec.smem_limit:
                return Plan("cluster", cluster, rows, H // cluster, smem, -(-B // rows) * cluster)
    return None


def cluster_waves(plan: Plan, spec: CardSpec = H100_SXM) -> int:
    """Waves of a cluster plan: its clusters over those the card of `spec` runs at once."""
    return -(-(plan.grid // plan.cluster) // spec.clusters_at_once(plan.cluster))


def resident_rows_a_thread(rows: int, H: int) -> int:
    """Rows a thread of a resident block of `rows` rows owns (`resident_rows_a_thread` in csrc/rnn_seq.cu): 4 or 2 (dividing
    rows) where that still leaves the block RESIDENT_MIN_THREADS threads (rows / that x H), else 1. More rows a thread share
    each read of wh from shared memory; 4 warps at least keep the SM's four schedulers busy."""
    for rt in (4, 2):
        if rows % rt == 0 and rows // rt * H >= RESIDENT_MIN_THREADS:
            return rt
    return 1


def resident_smem(H: int, rows: int) -> int:
    """Shared memory of one resident forward block (`resident_smem_bytes` in csrc/rnn_seq.cu), each part on 16 bytes: wh
    packed as [H][H][4] f32 and the carry h [2][rows][H] f32 (a step's inputs go through registers)."""
    return _a16(4 * 4 * H * H) + _a16(4 * 2 * rows * H)


def resident_bwd_smem(H: int, rows: int) -> int:
    """Shared memory of one resident backward block (`resident_bwd_smem_bytes` in csrc/rnn_seq.cu), each part on 16 bytes:
    wh [H][4H + 4] f32 (each row padded by 16 bytes) and the gate cotangents dg [2][rows][4H] f32."""
    GH = 4 * H
    return _a16(4 * H * (GH + 4)) + 2 * _a16(4 * rows * GH)


@functools.lru_cache(maxsize=256)
def resident_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM, backward: bool = False):
    """The resident design's plan on a card of `spec` (the forward's, or with `backward` the backward's), or None where it
    takes none: the GRU (it has no resident kernel), H not a multiple of 8, or a block of one row beyond the card's shared
    memory or RESIDENT_MAX_THREADS. Rows a block: the fewest powers of two that put the blocks on the SMs in one wave
    (ceil(B / rows) <= spec.sms) where B allows, halved while the block's threads exceed RESIDENT_MAX_THREADS or its shared
    memory (`resident_smem`, `resident_bwd_smem`: all of wh and the carry or the gate cotangents) spec.smem_limit. At DMLab's
    learner (16, 1024, 64) f32 on the H100 SXM: 8 rows, 128 blocks of 128 threads (4 rows a thread). The dtype changes
    nothing: wh is in f32 in shared memory, and a step's inputs go through registers."""
    del dtype
    if kind != "lstm" or H % 8:
        return None
    smem_of = resident_bwd_smem if backward else resident_smem
    rows = 1
    while -(-B // rows) > spec.sms:
        rows *= 2
    while rows > 1 and (rows // resident_rows_a_thread(rows, H) * H > RESIDENT_MAX_THREADS or smem_of(H, rows) > spec.smem_limit):
        rows //= 2
    if H > RESIDENT_MAX_THREADS or smem_of(H, rows) > spec.smem_limit:
        return None
    rt = resident_rows_a_thread(rows, H)
    return Plan("resident", 1, rows, H, smem_of(H, rows), -(-B // rows), tile_rows=rt, threads=rows // rt * H)


def resident_in_pad(I: int) -> int:
    """x's row in a resident_in block's shared memory, and wi's rows: I rounded up to 4 (`resident_in_pad` in csrc/rnn_seq.cu)."""
    return -(-I // 4) * 4


def resident_in_smem(H: int, rows: int, I: int, T: int, itemsize: int) -> int:
    """Shared memory of one fused resident forward block (`resident_in_smem_bytes` in csrc/rnn_seq.cu), each part on 16 bytes: wh
    packed as [H][H][4] f32, wi packed as [Ip][H][4] f32, the carry h [2][rows][H] f32, x of all T steps [T][rows][Ip] f32, the
    input parts [2][rows][H][4] f32, and in bf16 (`itemsize` 2) wh and wi as given ([H][4H], [I][4H]), where their copies land
    before the block packs them (f32 copies land in the packed parts and are packed in place)."""
    Ip, GH = resident_in_pad(I), 4 * H
    given = _a16(2 * H * GH) + _a16(2 * I * GH) if itemsize == 2 else 0
    return _a16(16 * H * H) + _a16(16 * Ip * H) + _a16(8 * rows * H) + _a16(4 * T * rows * Ip) + _a16(32 * rows * H) + given


def in_width(I: int, H: int) -> int:
    """Columns of the fused forward's saved xh = [x | the carry h | 1 | 0 ...]: I + H + 1 rounded up to 8 (rows on 16 bytes)."""
    return -(-(I + H + 1) // 8) * 8


@functools.lru_cache(maxsize=256)
def resident_in_plan(T: int, B: int, H: int, I: int, dtype, spec: CardSpec = H100_SXM):
    """The plan of `lstm_seq_in`'s kernel (the resident design with the input product folded in) on a card of `spec`, or None
    where it takes none: where `launch_plan` takes the resident design (H a multiple of 32: the kernel packs wi and wh a warp a
    row), the resident forward's rows and blocks, with twice its
    threads (its consumers and as many producers of the input parts), where those stay within RESIDENT_MAX_THREADS and the
    block's shared memory (`resident_in_smem`: x of all T steps staged at once) within spec.smem_limit. At DMLab's learner
    (16, 1024, 64) f32 with I=20 on the H100 SXM: 128 blocks of 8 rows and 256 threads, 116,736 bytes; no plan at (16, 4096,
    64), whose resident blocks have 512 threads already."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if I < 1 or H % 32 or launch_plan("lstm", T, B, H, dtype, spec).design != "resident":
        return None
    fwd = resident_plan("lstm", B, H, dtype, spec)
    smem = resident_in_smem(H, fwd.rows, I, T, 2 if dtype == torch.bfloat16 else 4)
    if 2 * fwd.threads > RESIDENT_MAX_THREADS or smem > spec.smem_limit:
        return None
    return dataclasses.replace(fwd, design="resident_in", smem=smem, threads=2 * fwd.threads)


@functools.lru_cache(maxsize=256)
def launch_plan(kind: str, T: int, B: int, H: int, dtype, spec: CardSpec = H100_SXM) -> Plan:
    """The design and its launch configuration, from the shape, the dtype and the card's spec: the
    cluster design where a slice fits (`cluster_plan`), except at H <= ROWS_OVER_WAVES_MAX_H, where the
    LSTM takes the resident design wherever `resident_plan` gives one, and the GRU the row design where
    its clusters need more than one wave; otherwise the grid design where `grid_plan` gives one
    (float32, H a multiple of 64), else the row design.

    The resident design in place of a cluster plan of one wave: it beat the cluster plan in turns by
    more than either's spread at DMLab's rollout slot (16, 64, 64) f32, 0.02787 ms against 0.05667 (each
    route's rounds spread by 0.00005 ms), and its last-value pass (16, 128, 64), 0.02787 against 0.05709
    (0.00003 and 0.00016), on an NVIDIA H100 80GB HBM3 at 700 W (`rnn_seq_turns --resident`; PERF.md
    section 6). Up to spec.sms rows a resident block holds one row whatever B is, and below 64 rows the
    same held in turns (shapes no path runs): (16, 8, 64) 0.02762 against 0.05605 (spreads 0.00003 and
    0.00006), (16, 24, 64) 0.02765 against 0.05603 (0.00002 and 0.00008)."""
    del T  # every step is alike; the plan does not depend on the sequence length
    plan = cluster_plan(kind, B, H, dtype, spec)
    if plan is not None and H <= ROWS_OVER_WAVES_MAX_H:
        resident = resident_plan(kind, B, H, dtype, spec)
        if resident is not None:
            return resident
        if cluster_waves(plan, spec) > 1:
            return row_plan(kind, B, H)
    if plan is not None:
        return plan
    return grid_plan(kind, B, H, dtype, spec) or row_plan(kind, B, H)


def max_active_clusters(kind: str, dtype, plan: Plan) -> int:
    """Clusters of the plan's size and shared memory that the card runs at once
    (cudaOccupancyMaxActiveClusters); what CardSpec.clusters_at_once holds at one block an SM."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return load_library().max_active_clusters(_gates(kind), int(dtype == torch.bfloat16), plan.cluster, plan.smem)


def grid_blocks_per_sm(kind: str, plan: Plan) -> int:
    """Blocks of the grid plan's size that one SM of the card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the plan counts on one (spec.sms blocks at most)."""
    return load_library().grid_blocks_per_sm(_gates(kind), plan.tile_rows, plan.tile_cols, plan.threads, plan.smem)


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def bwd_smem(kind: str, H: int, rows: int, itemsize: int) -> int:
    """Shared memory of one backward block (`bwd_smem_bytes` in csrc/rnn_seq.cu), each part on 16 bytes: the
    carried cotangents dh (and the LSTM's dc) [rows][H] f32, the step's gate cotangents [rows][G*H] f32, and
    the stage of the next step's inputs: x_proj (GRU) or proj (LSTM) and the GRU's h_proj [rows][G*H] in the
    input type, h_prev (GRU) or c (LSTM) and d_outs [rows][H] f32, resets [rows] f32."""
    G = _gates(kind)
    RH = rows * H
    carried = (1 if kind == "gru" else 2) * _a16(4 * RH)
    staged = (2 if kind == "gru" else 1) * _a16(itemsize * RH * G) + 2 * _a16(4 * RH) + _a16(4 * rows)
    return carried + _a16(4 * RH * G) + staged


@functools.lru_cache(maxsize=256)
def bwd_rows(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM) -> int:
    """Batch rows a block of the backward kernel owns (the row design, mirrored; ceil(B / rows) blocks): the
    largest power of two at most B / spec.sms and BWD_MAX_ROWS, so that there are at least as many blocks as
    SMs where B allows (1 where B < spec.sms), halved while a block's shared memory exceeds spec.smem_limit.
    More rows share each read of wh^T; fewer give more blocks."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    itemsize = 2 if dtype == torch.bfloat16 else 4
    rows = 1
    while rows * 2 <= min(BWD_MAX_ROWS, B // spec.sms):
        rows *= 2
    while rows > 1 and bwd_smem(kind, H, rows, itemsize) > spec.smem_limit:
        rows //= 2
    return rows


def bwd_grid_threads(units: int, rows: int, ksplit: int, passes: int = 1) -> int:
    """Threads of a grid backward block: `ksplit` x the 4 x 4 register tiles of one pass (`bwd_grid_threads` in
    csrc/rnn_seq.cu)."""
    return ksplit * (rows // passes // 4) * (units // 4)


def bwd_grid_smem(kind: str, H: int, units: int, rows: int, ksplit: int, kchunk: int, passes: int = 1) -> int:
    """Shared memory of one grid backward block (`bwd_grid_smem_bytes` in csrc/rnn_seq.cu), all f32: the rows of wh of
    the block's units, transposed, [G*H][units]; a pass's chunks of the gate cotangents [2][rows / passes][kchunk + 4];
    and where K is split, every thread's partial sums [threads][16]."""
    partials = bwd_grid_threads(units, rows, ksplit, passes) * 16 if ksplit > 1 else 0
    return 4 * (_gates(kind) * H * units + 2 * (rows // passes) * (kchunk + 4) + partials)


# K splits and passes a grid backward block may take, in the order tried: a K split needs a cell a thread (16 splits
# at least with 4 x 4 tiles), the rest applies the register tiles' cells, in passes over the rows
BWD_GRID_SPLITS = ((32, 1), (16, 1), (1, 1), (1, 2), (1, 4), (1, 8))


@functools.lru_cache(maxsize=256)
def bwd_grid_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM):
    """The grid design's plan for the float32 backward on a card of `spec` (a Plan of design "grid"; `cluster` is the
    unit slices), or None: it is planned exactly where the forward's `launch_plan` takes its grid design.

    A thread holds 4 x 4 accumulators. Slices of 16, 8, then 4 units (at most spec.sms slices): wider slices read dg
    from L2 fewer times, S*B*G*H*4 bytes a step. For each, as `grid_plan` does, the batch tiles that the SMs hold (one
    block an SM), and for each K split and pass count of BWD_GRID_SPLITS the fewest rows a tile, a multiple of passes x 4,
    that fill them; it fits where its threads stay within BWD_GRID_MAX_THREADS, where K is split each cell has a thread
    of its own, and the widest K chunk of at most 512 (a divisor of H, so that a GRU chunk lies in d_x_proj's r and z
    columns or in d_hn alone) gives a block's shared memory within spec.smem_limit. The plan has the most blocks; among
    equals the widest slices, then the first in order."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if launch_plan(kind, 1, B, H, dtype, spec).design != "grid":
        return None
    best, best_key = None, None
    for units in (16, 8, 4):
        slices = H // units
        if H % units or slices > spec.sms:
            continue
        most = min(spec.sms // slices, -(-B // 4))  # batch tiles that the SMs hold
        for ksplit, passes in BWD_GRID_SPLITS:
            step = passes * 4
            rows = -(-B // (most * step)) * step
            threads = bwd_grid_threads(units, rows, ksplit, passes)
            if threads > BWD_GRID_MAX_THREADS or (ksplit > 1 and rows * units > threads):
                continue
            for kchunk in (512, 256, 128, 64, 32, 16):
                if H % kchunk or kchunk % (4 * ksplit):
                    continue
                smem = bwd_grid_smem(kind, H, units, rows, ksplit, kchunk, passes)
                if smem <= spec.smem_limit:
                    tiles = -(-B // rows)
                    key = (tiles * slices, units)
                    if best is None or key > best_key:
                        best, best_key = Plan("grid", slices, rows, units, smem, tiles * slices, 4, 4, ksplit, kchunk, passes, threads), key
                    break
    return best


def bwd_cluster_k(kind: str, units: int, itemsize: int) -> int:
    """K of a cluster backward block's product: its G*U gate columns, rounded up to the mma's k16 in bf16
    (`bwd_cluster_k` in csrc/rnn_seq.cu)."""
    GU = _gates(kind) * units
    return -(-GU // 16) * 16 if itemsize == 2 else GU


def bwd_cluster_smem(kind: str, H: int, cluster: int, rows: int, itemsize: int, buffers: int = 2) -> int:
    """Shared memory of one cluster backward block (`bwd_cluster_smem_bytes` in csrc/rnn_seq.cu), each part on 16 bytes:
    the block's rows of pack_wh [K][H + pad] in the input type (K = bwd_cluster_k); its units' gate cotangents [rows][K]
    (bf16: a high and a low part, rows of K + 8; f32: rows of K); the receive slots [buffers][cluster][rows][U] f32; the
    stage of a step's inputs (x_proj or proj, and the GRU's h_proj, [rows][G*U] in the input type; h_prev or c, and d_outs,
    [rows][U] f32; resets [rows] f32); the carried cotangents [rows][U] f32 (the direct term of dh, and the LSTM's dc)."""
    G, U = _gates(kind), H // cluster
    K, HS = bwd_cluster_k(kind, U, itemsize), H + 16 // itemsize
    dg = 2 * _a16(2 * rows * (K + 8)) if itemsize == 2 else _a16(4 * rows * K)
    staged = (2 if kind == "gru" else 1) * _a16(itemsize * rows * G * U) + 2 * _a16(4 * rows * U) + _a16(4 * rows)
    return _a16(itemsize * K * HS) + dg + _a16(4 * buffers * rows * H) + staged + (2 if kind == "lstm" else 1) * _a16(4 * rows * U)


@functools.lru_cache(maxsize=256)
def bwd_cluster_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM, buffers: int = 0):
    """The cluster design's plan for the backward on a card of `spec` (a Plan of design "cluster"), or None: it is planned
    exactly where the forward's `launch_plan` takes its cluster design, with the forward's cluster and unit slice (so never a
    cluster size the card runs none of). Rows per cluster as `cluster_plan` takes them: the fewest that let all clusters
    run in one wave, in steps of 16 (bf16's m16) or 8 (f32), at most 64 / 32, lowered until the block's shared memory fits
    spec.smem_limit. Two receive buffers (one cluster barrier a step), or one (a second barrier a step) where the two
    buffers' slots would leave a cluster fewer rows than one buffer's: `selfplay`'s (32, 512, 512) bf16 on 32 rows in 16
    clusters (3 waves) rather than 16 rows in 32 (5 waves), at least as fast in chip_smoke.py's turns (phase `bwd`), where
    at equal rows two buffers are the faster. `buffers` forces a count."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    fwd = launch_plan(kind, 1, B, H, dtype, spec)
    if fwd.design != "cluster":
        return None
    itemsize = 2 if dtype == torch.bfloat16 else 4
    step, cap = (16, 64) if itemsize == 2 else (8, 32)
    want = -(-B // spec.clusters_at_once(fwd.cluster))

    def rows_that_fit(buffers):
        for rows in range(min(cap, max(step, -(-want // step) * step)), 0, -step):
            smem = bwd_cluster_smem(kind, H, fwd.cluster, rows, itemsize, buffers)
            if smem <= spec.smem_limit:
                return Plan("cluster", fwd.cluster, rows, fwd.units, smem, -(-B // rows) * fwd.cluster, buffers=buffers)
        return None

    if buffers:
        return rows_that_fit(buffers)
    two, one = rows_that_fit(2), rows_that_fit(1)
    return one if one is not None and (two is None or one.rows > two.rows) else two


@functools.lru_cache(maxsize=256)
def bwd_plan(kind: str, B: int, H: int, dtype, spec: CardSpec = H100_SXM) -> Plan:
    """The backward's design and launch configuration: the grid design where `bwd_grid_plan` gives one (float32, where
    the forward takes its grid design), the cluster design where `bwd_cluster_plan` gives one (where the forward takes its
    cluster design), the resident design where the forward takes its resident design (`resident_plan` of the backward's
    shared memory), else the row design, `bwd_rows` rows a block (`cluster` 1, `units` H)."""
    plan = bwd_grid_plan(kind, B, H, dtype, spec) or bwd_cluster_plan(kind, B, H, dtype, spec)
    if plan is not None:
        return plan
    if launch_plan(kind, 1, B, H, dtype, spec).design == "resident":
        return resident_plan(kind, B, H, dtype, spec, backward=True)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return bwd_row_plan(kind, B, H, bwd_rows(kind, B, H, dtype, spec), 2 if dtype == torch.bfloat16 else 4)


def bwd_row_plan(kind: str, B: int, H: int, rows: int, itemsize: int) -> Plan:
    """The backward's row design at `rows` batch rows a block."""
    return Plan("rows", 1, rows, H, bwd_smem(kind, H, rows, itemsize), -(-B // rows))


def max_active_bwd_clusters(kind: str, dtype, plan: Plan) -> int:
    """Clusters of the cluster backward plan's size and shared memory that the card runs at once
    (cudaOccupancyMaxActiveClusters for the backward kernel); 0 where none fits."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return load_library().bwd_max_active_clusters(_gates(kind), int(dtype == torch.bfloat16), plan.cluster, plan.smem)


def grid_bwd_blocks_per_sm(kind: str, plan: Plan) -> int:
    """Blocks of the grid backward plan's size that one SM of the card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the plan counts on one (spec.sms blocks at most)."""
    return load_library().grid_bwd_blocks_per_sm(_gates(kind), plan.threads, plan.smem)


def pack_wh(wh: torch.Tensor, plan: Plan) -> torch.Tensor:
    """wh [H, G*H] -> [cluster, G*U, H]: block r's gate columns g*H + r*U + u (u < U) as rows
    g*U + u, each contiguous along K, which is the layout of the mma's B operand (in the grid
    design, slice r's columns; the cluster backward reads block r's rows as its [K][H] operand, by
    ldmatrix.trans in bf16). The row design reads wh as it is; the resident forward reads it in float32 as [H][H][4] (row k,
    unit j, gate g: a thread's four gate weights of a row in one 16-byte read)."""
    if plan.design == "resident":
        H = wh.shape[0]
        return wh.float().reshape(H, 4, H).transpose(1, 2).contiguous()
    if plan.design == "rows":
        return wh
    H = wh.shape[0]
    G = wh.shape[1] // H
    return wh.t().reshape(G, plan.cluster, plan.units, H).transpose(0, 1).reshape(plan.cluster, G * plan.units, H).contiguous()


def unpack_wh(packed: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The inverse of `pack_wh` (the resident design's: in float32)."""
    if plan.design == "resident":
        return packed.transpose(1, 2).reshape(packed.shape[0], -1).contiguous()
    if plan.design == "rows":
        return packed
    H = packed.shape[-1]
    G = packed.shape[1] // plan.units
    return packed.reshape(plan.cluster, G, plan.units, H).transpose(0, 1).reshape(G * H, H).t().contiguous()


# ------------------------------------------------------------------ build and load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA RNN kernels cannot be built")


def library_path(defines: Tuple[str, ...] = (), source: Path = SOURCE) -> Path:
    """The built library for the sources and flags (keyed by their hash)."""
    digest = hashlib.sha256(Path(source).read_bytes() + " ".join(NVCC_FLAGS + list(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"rnn_seq_{digest}.so"


def build(defines: Tuple[str, ...] = (), source: Path = SOURCE) -> Path:
    """Compile `csrc/rnn_seq.cu` (or another version of it, `source`) into `_build/` unless this
    version is already there; `defines` are extra -D flags (the phase clock of
    `ops/rnn_seq_phases.py`). The compiler's output (ptxas register and shared-memory report) goes
    to a .log beside it."""
    path = library_path(defines, source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def bind(path: Path, entries: Tuple[str, ...] = ()):
    """Load a built library and declare its launch functions (`entries`: all of them by default;
    an older version of the source may lack some)."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "gru_seq_forward": [ptr] * 7 + [i32] * 7 + [ptr], "lstm_seq_forward": [ptr] * 6 + [i32] * 7 + [ptr],
        "gru_rows_forward": [ptr] * 7 + [i32] * 4 + [ptr], "lstm_rows_forward": [ptr] * 6 + [i32] * 4 + [ptr],
        "gru_grid_forward": [ptr] * 8 + [i32] * 12 + [ptr], "lstm_grid_forward": [ptr] * 7 + [i32] * 12 + [ptr],
        "gru_seq_backward": [ptr] * 10 + [i32] * 6 + [ptr], "lstm_seq_backward": [ptr] * 9 + [i32] * 6 + [ptr],
        "gru_seq_grid_backward": [ptr] * 10 + [i32] * 10 + [ptr], "lstm_seq_grid_backward": [ptr] * 9 + [i32] * 10 + [ptr],
        "gru_seq_cluster_backward": [ptr] * 10 + [i32] * 8 + [ptr], "lstm_seq_cluster_backward": [ptr] * 9 + [i32] * 8 + [ptr],
        "max_active_clusters": [i32] * 4, "grid_blocks_per_sm": [i32] * 5, "grid_bwd_blocks_per_sm": [i32] * 3,
        "bwd_max_active_clusters": [i32] * 4,
        "lstm_resident_forward": [ptr] * 6 + [i32] * 6 + [ptr], "lstm_seq_resident_backward": [ptr] * 9 + [i32] * 6 + [ptr],
        "lstm_resident_in_forward": [ptr] * 11 + [ctypes.c_longlong] * 2 + [i32] * 8 + [ptr],
        "lstm_seq_resident_in_backward": [ptr] * 9 + [i32] * 6 + [ptr],
    }
    for name in entries or signatures:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = signatures[name], i32
    return lib


def load_library(defines: Tuple[str, ...] = ()):
    """Build if needed and load the kernels' shared library (once per process: the first
    call's `defines` hold for the process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build(defines))
    return _lib


# ------------------------------------------------------------------ launches


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(x_proj: torch.Tensor, gates: int) -> Tuple[int, int, int]:
    if x_proj.dim() != 3 or x_proj.shape[-1] % gates != 0:
        raise ValueError(f"x_proj must be [T, B, {gates}*H], got {tuple(x_proj.shape)}")
    T, B, G = x_proj.shape
    H = G // gates
    if x_proj.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x_proj dtype {x_proj.dtype} not supported (float32 or bfloat16)")
    if T < 1 or B < 1 or not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"unsupported shape T={T}, B={B}, H={H} (T, B >= 1, 1 <= H <= {MAX_HIDDEN})")
    return T, B, H


def _kernel_name(kind: str, plan: Plan) -> str:
    return {"cluster": f"{kind}_seq", "grid": f"{kind}_seq_grid", "rows": f"{kind}_seq_rows", "resident": f"{kind}_seq_resident",
            "resident_in": f"{kind}_seq_resident_in"}[plan.design]


def _launch(kind, x_proj, state0, resets, wh, bh, plan):
    """Checks, allocates the outputs and launches the kernel on the current stream: `plan`, or the
    plan for the spec of the card that x_proj lies on. A launch the card refuses raises."""
    T, B, H = _check_common(x_proj, _gates(kind))
    G, dev, dt = _gates(kind), x_proj.device, x_proj.dtype
    _check("x_proj", x_proj, (T, B, G * H), dt, dev)
    _check("h0" if kind == "gru" else "hc0", state0, (B, H if kind == "gru" else 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("wh", wh, (H, G * H), dt, dev)
    if kind == "gru":
        _check("bh", bh, (G * H,), dt, dev)
    spec = card_spec(dev)
    plan = plan or launch_plan(kind, T, B, H, dt, spec)
    if plan.design == "grid" and dt != torch.float32:
        raise ValueError(f"the grid design takes float32, not {dt}")
    if plan.design == "resident" and kind != "lstm":
        raise ValueError("the resident design takes the LSTM")
    if plan.design != "rows" and x_proj.data_ptr() % 16:
        # a view at an odd offset: the cluster design copies x_proj in 16-byte pieces and the grid design reads it in pieces
        # of up to 16 bytes (load_v). The resident kernel reads it by element and needs no alignment: its copy is kept only
        # so that every design but the row design gets x_proj on 16 bytes (no path passes such a view: x_proj is a Linear's)
        x_proj = x_proj.clone()
    lib = load_library()
    outs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    state = torch.empty_like(state0)
    w = pack_wh(wh, plan)
    ptrs = [x_proj.data_ptr(), state0.data_ptr(), resets.data_ptr(), w.data_ptr()]
    ptrs += [bh.data_ptr()] if kind == "gru" else []
    ptrs += [outs.data_ptr(), state.data_ptr()]
    dims = [T, B, H, int(dt == torch.bfloat16)]
    if plan.design == "cluster":
        dims += [plan.cluster, plan.rows, plan.smem]
    if plan.design == "grid":  # the carry's double buffer between the steps, before outs; the kernel allocates nothing
        ptrs.insert(len(ptrs) - 2, torch.empty((2, B, H), dtype=torch.float32, device=dev).data_ptr())
        dims = [T, B, H, plan.units, plan.rows, plan.tile_rows, plan.tile_cols, plan.ksplit, plan.kchunk, plan.passes,
                plan.threads, plan.smem]
    if plan.design == "resident":
        dims += [plan.rows, plan.smem]
    fn = getattr(lib, {"cluster": f"{kind}_seq_forward", "grid": f"{kind}_grid_forward", "rows": f"{kind}_rows_forward",
                       "resident": f"{kind}_resident_forward"}[plan.design])
    with torch.cuda.device(dev):
        err = fn(*ptrs, *dims, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} (plan {plan}, on a card of {spec.sms} SMs: {spec})")
    _launches[_kernel_name(kind, plan)] += 1
    return outs, state


def _launch_gru(x_proj, h0, resets, wh, bh, plan=None):
    """`plan` defaults to `launch_plan` of the shape on this card; chip_smoke.py passes the row
    design's plan to time the first design beside the planned one, and another card's plan."""
    return _launch("gru", x_proj, h0, resets, wh, bh, plan)


def _launch_lstm(x_proj, hc0, resets, wh, plan=None):
    return _launch("lstm", x_proj, hc0, resets, wh, None, plan)


def row_plan(kind: str, B: int, H: int) -> Plan:
    """The row design's plan for any shape (what `launch_plan` returns where no cluster fits)."""
    return Plan("rows", 1, ROW_TILE, H, (2 if kind == "gru" else 3) * ROW_TILE * H * 4, -(-B // ROW_TILE))


def _bwd_kernel_name(kind: str, plan: Plan) -> str:
    return {"grid": f"{kind}_seq_grid_bwd", "cluster": f"{kind}_seq_cluster_bwd", "rows": f"{kind}_seq_bwd",
            "resident": f"{kind}_seq_resident_bwd"}[plan.design]


def _launch_bwd(kind, d_outs, d_final, resets, a, h_proj, s, wh, rows=None, plan=None):
    """Checks, allocates the outputs (and the LSTM's cell-state scratch) and launches the backward kernel on the
    current stream: `plan`, or the row design at `rows` batch rows a block, or by default `bwd_plan` for the spec of
    the card that `a` lies on (the grid or the cluster design where the forward takes it). A refused launch raises;
    nothing falls back to another design."""
    G = _gates(kind)
    T, B, H = _check_common(a, G)
    dev, dt = a.device, a.dtype
    _check("d_outs", d_outs, (T, B, H), torch.float32, dev)
    _check("d_h_final" if kind == "gru" else "d_hc_final", d_final, (B, H if kind == "gru" else 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    if kind == "gru":
        _check("h_proj", h_proj, (T, B, G * H), dt, dev)
        _check("h_prev", s, (T, B, H), torch.float32, dev)
    else:
        _check("hc0", s, (B, 2 * H), torch.float32, dev)
    _check("wh", wh, (H, G * H), dt, dev)
    spec = card_spec(dev)
    if rows is not None:
        plan = bwd_row_plan(kind, B, H, rows, a.element_size())
    plan = plan or bwd_plan(kind, B, H, dt, spec)
    design = plan.design
    if design == "grid" and dt != torch.float32:
        raise ValueError(f"the grid backward takes float32, not {dt}")
    if design == "resident" and kind != "lstm":
        raise ValueError("the resident backward takes the LSTM")
    # [G*H, H] for the row design: thread k reads column k, neighbouring threads neighbouring addresses; the grid
    # design reads the rows of wh of its units as they are; the cluster design the forward's slices (pack_wh); the
    # resident design all of wh as it is, in float32
    w = {"rows": lambda: wh.t().contiguous(), "grid": lambda: wh, "cluster": lambda: pack_wh(wh, plan),
         "resident": lambda: wh.float()}[design]()
    d_a, d_state0 = torch.empty_like(a), torch.empty_like(d_final)
    if kind == "gru":
        outputs = (d_a, torch.empty((T, B, H), dtype=dt, device=dev), d_state0)
        ptrs = [d_outs, d_final, resets, a, h_proj, s, w, *outputs]
    else:
        outputs = (d_a, d_state0)
        ptrs = [d_outs, d_final, resets, a, s, w, torch.empty((T, B, H), dtype=torch.float32, device=dev), *outputs]
    # the grid and cluster designs read their inputs in 16-byte pieces, the resident design wh alone (its other inputs by
    # element, copied as the forward copies x_proj): a view at an odd offset is copied
    if design != "rows":
        ptrs = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ptrs]
    if design == "grid":
        name = f"{kind}_seq_grid_backward"
        dims = [T, B, H, plan.units, plan.rows, plan.ksplit, plan.kchunk, plan.passes, plan.threads, plan.smem]
    elif design == "cluster":
        name = f"{kind}_seq_cluster_backward"
        dims = [T, B, H, int(dt == torch.bfloat16), plan.cluster, plan.rows, plan.buffers, plan.smem]
    elif design == "resident":
        name = f"{kind}_seq_resident_backward"
        dims = [T, B, H, int(dt == torch.bfloat16), plan.rows, plan.smem]
    else:
        name = f"{kind}_seq_backward"
        dims = [T, B, H, int(dt == torch.bfloat16), plan.rows, plan.smem]
    fn = getattr(load_library(), name)
    with torch.cuda.device(dev):
        err = fn(*[p.data_ptr() for p in ptrs], *dims, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        laid = {"grid": f"plan {plan}: {plan.grid // plan.cluster} batch tiles x {plan.cluster} slices of {plan.units} units, "
                        f"{plan.threads} threads",
                "cluster": f"plan {plan}: {plan.grid // plan.cluster} clusters of {plan.cluster} blocks, {plan.rows} rows and "
                           f"{plan.units} units a block, {plan.buffers} receive buffers",
                "resident": f"plan {plan}: {plan.rows} rows a block ({plan.tile_rows} a thread), {plan.grid} blocks of {plan.threads} threads",
                "rows": f"{plan.rows} rows a block, {plan.grid} blocks"}[design]
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} (T={T}, B={B}, H={H}, {dt}: {laid}, {plan.smem} bytes of "
                           f"shared memory, on a card of {spec.sms} SMs: {spec})")
    _launches[_bwd_kernel_name(kind, plan)] += 1
    return outputs


def _launch_gru_bwd(d_outs, d_h_final, resets, x_proj, h_proj, h_prev, wh, rows=None, plan=None):
    """The planned backward kernel (`gru_seq_grid_bwd`, `gru_seq_cluster_bwd` or `gru_seq_bwd`), with
    gru_seq_bwd_reference's signature; `rows` and `plan` as `_launch_bwd`."""
    return _launch_bwd("gru", d_outs, d_h_final, resets, x_proj, h_proj, h_prev, wh, rows, plan)


def _launch_lstm_bwd(d_outs, d_hc_final, resets, proj, hc0, wh, rows=None, plan=None):
    """The planned backward kernel (`lstm_seq_grid_bwd`, `lstm_seq_cluster_bwd`, `lstm_seq_resident_bwd` or `lstm_seq_bwd`),
    with lstm_seq_bwd_reference's signature."""
    return _launch_bwd("lstm", d_outs, d_hc_final, resets, proj, None, hc0, wh, rows, plan)


def _launch_lstm_in(x, wi, bi, hc0, resets, wh, save=False, plan=None):
    """Checks, allocates the outputs and launches `lstm_seq_in`'s kernel (`lstm_resident_in_forward`) on the current stream:
    `plan`, or `resident_in_plan` for the spec of the card that x lies on. x [T,B,I] goes at its strides (a copy only where its
    last dimension is strided), wi, bi and wh as they are: the kernel lays wi and wh out in shared memory itself. With `save`,
    the kernel also writes the backward's buffers. -> (outs, hc_final, proj, cells, xh); the last three None without `save`.
    A plan the card refuses raises; where there is no plan, the caller takes the unfused route."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be [T, B, I] in float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    T, B, I = x.shape
    H, dev, dt = wh.shape[0], x.device, x.dtype
    if T < 1 or B < 1 or I < 1 or not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"unsupported shape T={T}, B={B}, I={I}, H={H}")
    _check("wi", wi, (I, 4 * H), dt, dev)
    _check("bi", bi, (4 * H,), dt, dev)
    _check("hc0", hc0, (B, 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    if x.stride(2) != 1:
        x = x.contiguous()
    spec = card_spec(dev)
    plan = plan or resident_in_plan(T, B, H, I, dt, spec)
    if plan is None or plan.design != "resident_in":
        raise ValueError(f"no plan of lstm_seq_in's kernel at T={T}, B={B}, I={I}, H={H}, {dt} on a card of {spec.sms} SMs: {plan}")
    K = in_width(I, H)
    outs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    state = torch.empty_like(hc0)
    saved = (torch.empty((T, B, 4 * H), dtype=dt, device=dev), torch.empty((T, B, H), dtype=torch.float32, device=dev),
             torch.empty((T, B, K), dtype=dt, device=dev)) if save else (None, None, None)
    ptrs = [x, wi, bi, hc0, resets, wh, outs, state, *saved]
    fn = load_library().lstm_resident_in_forward
    with torch.cuda.device(dev):
        err = fn(*[t.data_ptr() if t is not None else None for t in ptrs], x.stride(0), x.stride(1), T, B, H, I, K,
                 int(dt == torch.bfloat16), plan.rows, plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_resident_in_forward launch failed: CUDA error {err} (T={T}, B={B}, I={I}, H={H}, {dt}: plan {plan}, "
                           f"on a card of {spec.sms} SMs: {spec})")
    _launches["lstm_seq_resident_in"] += 1
    return (outs, state, *saved)


def _launch_lstm_in_bwd(d_outs, d_hc_final, resets, proj, hc0, wh, cells, plan=None):
    """The backward of `lstm_seq_in`'s kernel on the buffers its forward saved (`lstm_seq_resident_in_backward`: the resident
    backward kernel reading the forward's proj and cell states, its cell-state pass skipped), with lstm_seq_bwd_reference's
    signature; `d_hc_final` may be None (a zero cotangent). -> (d_proj in proj's dtype, d_hc0 f32). A refused launch raises."""
    T, B, H = _check_common(proj, 4)
    dev, dt = proj.device, proj.dtype
    _check("d_outs", d_outs, (T, B, H), torch.float32, dev)
    if d_hc_final is not None:
        _check("d_hc_final", d_hc_final, (B, 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("hc0", hc0, (B, 2 * H), torch.float32, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    _check("cells", cells, (T, B, H), torch.float32, dev)
    spec = card_spec(dev)
    plan = plan or resident_plan("lstm", B, H, dt, spec, backward=True)
    if plan is None or plan.design != "resident":
        raise ValueError(f"no resident backward plan at B={B}, H={H}, {dt} on a card of {spec.sms} SMs")
    w = wh.float()
    if w.data_ptr() % 16:  # copied into shared memory 16 bytes at a time; its other inputs are read by element
        w = w.clone()
    d_proj, d_hc0 = torch.empty_like(proj), torch.empty_like(hc0)
    ptrs = [d_outs, d_hc_final, resets, proj, hc0, w, cells, d_proj, d_hc0]
    fn = load_library().lstm_seq_resident_in_backward
    with torch.cuda.device(dev):
        err = fn(*[t.data_ptr() if t is not None else None for t in ptrs], T, B, H, int(dt == torch.bfloat16), plan.rows, plan.smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_resident_in_backward launch failed: CUDA error {err} (T={T}, B={B}, H={H}, {dt}: plan {plan}: "
                           f"{plan.rows} rows a block ({plan.tile_rows} a thread), {plan.grid} blocks of {plan.threads} threads, "
                           f"{plan.smem} bytes of shared memory, on a card of {spec.sms} SMs: {spec})")
    _launches["lstm_seq_resident_in_bwd"] += 1
    return d_proj, d_hc0


def _forward(launch, reference, args):
    device = args[0].device
    if device.type == "cuda":
        return launch(*args)
    if device.type == "cpu":
        return reference(*args)
    raise ValueError(f"no RNN sequence implementation for device {device}")


def _recompute_grads(reference, args, needs, grad_outputs):
    """Backward by rematerialization: rerun the plain version under autograd (the CPU's backward, as JAX's
    `_bwd` and `_lstm_bwd` differentiate the scan)."""
    with torch.enable_grad():
        inputs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
        outputs = reference(*inputs)
        wanted = [i for i, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(outputs, wanted, grad_outputs, allow_unused=True)) if wanted else iter(())
        return tuple(next(grads) if n else None for n in needs)


def _carries_in(state0, resets, outs):
    """The h entering each step, [T,B,H] f32, from what the forward saved: state0's h at step 0, then the
    step before's output, 0 where that step reset (outs are taken before the reset)."""
    H = outs.shape[-1]
    return torch.cat([state0[None, :, :H], torch.where(resets[:-1, :, None] > 0, 0.0, outs[:-1])])


def gru_seq_backward(x_proj, h0, resets, wh, bh, outs, d_outs, d_h_final, recurrence=_launch_gru_bwd):
    """gru_seq's backward from its forward's inputs and `outs`: the prologue (the carries entering each step
    and their projection h_prev @ wh + bh, one product over T*B rows), the reverse-time recurrence
    (`recurrence`: the kernel `gru_seq_bwd`; the tests and chip_smoke.py pass gru_seq_bwd_reference) and the
    epilogue (d_wh = h_prev^T @ [da_r, da_z, d_hn] over T*B rows, the r and z columns read from d_x_proj, and
    d_bh their sum). -> (d_x_proj in x_proj's dtype, d_h0 f32, d_wh, d_bh in theirs); resets get none."""
    H = wh.shape[0]
    h_prev = _carries_in(h0, resets, outs)
    h_in = h_prev.to(x_proj.dtype)
    d_x, d_hn, d_h0 = recurrence(d_outs.float().contiguous(), d_h_final.float().contiguous(), resets, x_proj, h_in @ wh + bh, h_prev, wh)
    rz, h_t = d_x[..., : 2 * H].flatten(0, 1), h_in.flatten(0, 1).t()
    d_wh = torch.cat([h_t @ rz, h_t @ d_hn.flatten(0, 1)], dim=1)
    d_bh = torch.cat([rz.sum(0), d_hn.sum((0, 1))])
    return d_x, d_h0, d_wh.to(wh.dtype), d_bh.to(bh.dtype)


def lstm_seq_backward(x_proj, hc0, resets, wh, outs, d_outs, d_hc_final, recurrence=_launch_lstm_bwd):
    """lstm_seq's backward, as gru_seq_backward: the prologue proj = x_proj + h_prev @ wh, the recurrence
    (the kernel `lstm_seq_bwd`, or lstm_seq_bwd_reference; it recomputes the cell state) and
    d_wh = h_prev^T @ d_x_proj. -> (d_x_proj, d_hc0 f32, d_wh)."""
    h_in = _carries_in(hc0, resets, outs).to(x_proj.dtype)
    d_x, d_hc0 = recurrence(d_outs.float().contiguous(), d_hc_final.float().contiguous(), resets, x_proj + h_in @ wh, hc0, wh)
    return d_x, d_hc0, (h_in.flatten(0, 1).t() @ d_x.flatten(0, 1)).to(wh.dtype)


class GRUSeqFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, h0, resets, wh, bh):
        outs, h_final = _forward(_launch_gru, gru_seq_reference, (x_proj, h0, resets, wh, bh))
        ctx.save_for_backward(x_proj, h0, resets, wh, bh, outs)
        return outs, h_final

    @staticmethod
    def backward(ctx, d_outs, d_h_final):
        *args, outs = ctx.saved_tensors
        needs = list(ctx.needs_input_grad)
        needs[2] = False  # resets get no gradient
        if args[0].device.type != "cuda":
            return _recompute_grads(gru_seq_reference, args, needs, (d_outs, d_h_final))
        d_x, d_h0, d_wh, d_bh = gru_seq_backward(*args, outs, d_outs, d_h_final)  # autograd drops what no input needs
        return d_x, d_h0, None, d_wh, d_bh


class LSTMSeqFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, hc0, resets, wh):
        outs, hc_final = _forward(_launch_lstm, lstm_seq_reference, (x_proj, hc0, resets, wh))
        ctx.save_for_backward(x_proj, hc0, resets, wh, outs)
        return outs, hc_final

    @staticmethod
    def backward(ctx, d_outs, d_hc_final):
        *args, outs = ctx.saved_tensors
        needs = list(ctx.needs_input_grad)
        needs[2] = False
        if args[0].device.type != "cuda":
            return _recompute_grads(lstm_seq_reference, args, needs, (d_outs, d_hc_final))
        d_x, d_hc0, d_wh = lstm_seq_backward(*args, outs, d_outs, d_hc_final)
        return d_x, d_hc0, None, d_wh


def lstm_seq_in_backward(wi, hc0, resets, wh, proj, cells, xh, d_outs, d_hc_final, recurrence=_launch_lstm_in_bwd):
    """lstm_seq_in's backward from the buffers its forward saved: the recurrence (`recurrence`: the kernel
    `lstm_seq_resident_in_bwd`, one launch; the tests and chip_smoke.py pass lstm_seq_bwd_reference) gives d_proj, which is
    also d_x_proj; then one product, xh^T @ d_proj over T*B rows ([x | h_prev | 1 | 0 ...]^T: the rows of d_wi, d_wh and d_bi),
    and d_x = d_proj @ wi^T. -> (d_x [T,B,I], d_wi, d_bi, d_wh in their dtypes, d_hc0 f32); `d_hc_final` may be None."""
    I, H = wi.shape[0], wh.shape[0]
    d_outs = d_outs.float().contiguous() if d_outs is not None else torch.zeros(proj.shape[:2] + (H,), device=proj.device)
    d_hc_final = d_hc_final.float().contiguous() if d_hc_final is not None else None
    d_proj, d_hc0 = recurrence(d_outs, d_hc_final, resets, proj, hc0, wh, cells)
    g = xh.flatten(0, 1).t() @ d_proj.flatten(0, 1)
    return d_proj @ wi.t(), g[:I], g[I + H], g[I:I + H], d_hc0


class LSTMSeqInFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wi, bi, hc0, resets, wh, save):
        ctx.set_materialize_grads(False)
        if x.device.type == "cuda":
            outs, hc_final, *saved = _launch_lstm_in(x, wi, bi, hc0, resets, wh, save=save)
            if save:
                ctx.save_for_backward(wi, hc0, resets, wh, *saved)
            return outs, hc_final
        if x.device.type != "cpu":
            raise ValueError(f"no RNN sequence implementation for device {x.device}")
        outs, hc_final = lstm_seq_in_reference(x, wi, bi, hc0, resets, wh)
        ctx.save_for_backward(x, wi, bi, hc0, resets, wh)
        return outs, hc_final

    @staticmethod
    def backward(ctx, d_outs, d_hc_final):
        saved = ctx.saved_tensors
        if saved[0].device.type != "cuda":
            needs = list(ctx.needs_input_grad[:6])
            needs[4] = False  # resets get no gradient
            grad_outputs = (d_outs if d_outs is not None else torch.zeros(saved[0].shape[:2] + (saved[5].shape[0],)),
                            d_hc_final if d_hc_final is not None else torch.zeros_like(saved[3]))
            return (*_recompute_grads(lstm_seq_in_reference, saved, needs, grad_outputs), None)
        if not saved:
            raise RuntimeError("lstm_seq_in's forward saved no buffers for a backward (it ran where no input needed a gradient)")
        wi, hc0, resets, wh, proj, cells, xh = saved
        d_x, d_wi, d_bi, d_wh, d_hc0 = lstm_seq_in_backward(wi, hc0, resets, wh, proj, cells, xh, d_outs, d_hc_final)
        return d_x, d_wi, d_bi, d_hc0, None, d_wh, None


def gru_seq(x_proj, h0, resets, wh, bh):
    """GRU recurrence (see module doc). CUDA: the hand-written kernel; CPU: the plain version."""
    return GRUSeqFunction.apply(x_proj, h0, resets, wh, bh)


def lstm_seq(x_proj, hc0, resets, wh):
    """LSTM recurrence (see module doc). CUDA: the hand-written kernel; CPU: the plain version."""
    return LSTMSeqFunction.apply(x_proj, hc0, resets, wh)


def lstm_seq_in(x, wi, bi, hc0, resets, wh):
    """The LSTM from its raw input: x [T,B,I] @ wi [I,4H] + bi [4H] in x's dtype, then lstm_seq's recurrence (hc0 [B,2H] f32,
    resets [T,B] f32, wh [H,4H]) -> (outs [T,B,H] f32, hc_final [B,2H] f32). CUDA: where `resident_in_plan` gives a plan (where
    `launch_plan` takes the resident design: DMLab's instruction encoder), one launch of the fused kernel,
    `lstm_seq_resident_in`, and a backward of one launch, `lstm_seq_resident_in_bwd`, and two products; elsewhere the Linear,
    then `lstm_seq`. CPU: the plain version (`lstm_seq_in_reference`), its gradient by `_recompute_grads`."""
    T, B, I = x.shape
    if in_route(x.device, T, B, wh.shape[0], I, x.dtype) == "unfused":
        return lstm_seq((x @ wi + bi).contiguous(), hc0, resets, wh)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (x, wi, bi, hc0, wh))
    return LSTMSeqInFunction.apply(x, wi, bi, hc0, resets, wh, save)


def in_route(device, T: int, B: int, H: int, I: int, dtype) -> str:
    """The way `lstm_seq_in` takes: "fused" on a CUDA device where `resident_in_plan` gives a plan for the card's spec,
    "unfused" on another CUDA shape (the Linear, then `lstm_seq`), "plain" elsewhere (the CPU's plain version; any other
    device raises in it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    return "fused" if resident_in_plan(T, B, H, I, dtype, card_spec(device)) is not None else "unfused"


_launches = {"gru_seq": 0, "gru_seq_rows": 0, "gru_seq_grid": 0, "lstm_seq": 0, "lstm_seq_rows": 0, "lstm_seq_grid": 0,
             "gru_seq_bwd": 0, "lstm_seq_bwd": 0, "gru_seq_grid_bwd": 0, "lstm_seq_grid_bwd": 0, "gru_seq_cluster_bwd": 0,
             "lstm_seq_cluster_bwd": 0, "lstm_seq_resident": 0, "lstm_seq_resident_bwd": 0, "lstm_seq_resident_in": 0,
             "lstm_seq_resident_in_bwd": 0}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset: "gru_seq"/"lstm_seq" for the cluster
    design, "gru_seq_grid"/"lstm_seq_grid" for the grid design, "gru_seq_rows"/"lstm_seq_rows" for
    the row design (the forward's designs), "gru_seq_bwd"/"lstm_seq_bwd" for the backward's row design,
    "gru_seq_grid_bwd"/"lstm_seq_grid_bwd" for its grid design and "gru_seq_cluster_bwd"/"lstm_seq_cluster_bwd" for
    its cluster design, "lstm_seq_resident"/"lstm_seq_resident_bwd" for the LSTM's resident design, forward and backward, and
    "lstm_seq_resident_in"/"lstm_seq_resident_in_bwd" for `lstm_seq_in`'s kernels (the input product folded in)."""
    return dict(_launches)


def add_launch_counts(counts: dict) -> None:
    """Adds `counts` (kernel name -> launches) to the counts: the kernels a CUDA graph's replay launches, which pass
    through no launcher of this module (`algo/minibatch_graphs.py`)."""
    for name, n in counts.items():
        _launches[name] += n
