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
dependent steps sets the time. `launch_plan` picks one of two designs from the
shape alone (see the source note in `csrc/rnn_seq.cu`):

- "cluster": the gate columns of `wh` are split across the blocks of a
  thread-block cluster, each block keeps its slice in shared memory for all T
  steps and the new carry is exchanged through distributed shared memory, one
  cluster barrier per step; bf16 products on the tensor cores. The wrapper
  repacks `wh` into per-block slices (`pack_wh`, one gather per call);
- "rows": the first design, for shapes whose slice does not fit a block even
  at 16 blocks per cluster, or whose width per block is no power of two: one
  block per 4 batch rows, `wh` re-read from L2.

Gradients: each kernel sits in a `torch.autograd.Function` whose backward
recomputes through the plain version under autograd. The JAX package has no
backward kernel either (`_bwd`, `_lstm_bwd`: remat through the scan
reference), so this is the same design. `resets` get no gradient.

Dispatch: a CUDA tensor launches the planned kernel or raises; a CPU tensor
runs the plain version. `launch_counts()` counts the launches of each kernel,
per design ("gru_seq" is the cluster design, "gru_seq_rows" the row design).
"""

from __future__ import annotations

import ctypes
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
SMEM_LIMIT = 232_448  # shared memory one block may use on the H100 (227 KB)
# clusters of 8 and of 16 blocks that run at once on the H100 SXM with one block per SM
# (cudaOccupancyMaxActiveClusters): a cluster lives in one GPC, so 15 x 8 = 120 SMs, not 132
MAX_CLUSTERS = {8: 15, 16: 7}
ROW_TILE = 4  # batch rows per block in the row design (kTile in csrc/rnn_seq.cu)

_lib = None
_lib_lock = threading.Lock()


# ------------------------------------------------------------------ plain versions


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) with each op in x's dtype: the kernels' form (and the Pallas
    kernels', `pallas_gru.py:70-75`); torch.sigmoid rounds differently in bf16."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


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


# ------------------------------------------------------------------ launch plan


@dataclass(frozen=True)
class Plan:
    """How one call is laid out on the card. A "cluster" launch has `grid` blocks in clusters of
    `cluster`; each cluster owns `rows` batch rows and each of its blocks `units` hidden units.
    A "rows" launch has one block per `rows` batch rows, each owning all `units` = H units."""

    design: str  # "cluster" or "rows"
    cluster: int  # blocks per cluster (1 in the row design)
    rows: int  # batch rows per cluster (per block in the row design)
    units: int  # hidden units per block
    smem: int  # dynamic shared memory per block, bytes
    grid: int  # blocks


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


@functools.lru_cache(maxsize=256)
def launch_plan(kind: str, T: int, B: int, H: int, dtype) -> Plan:
    """The design and its launch configuration, from the shape and dtype alone.

    Cluster design where a slice fits: 8 blocks per cluster, else 16 (a non-portable cluster
    size on the H100); the hidden units of a block are a power of two, at least 8 (the
    mma's n8, 16-byte copies, and index arithmetic by shifts). Rows per cluster: the fewest that let all clusters run in one wave
    (MAX_CLUSTERS), in steps of the product's row granularity (16 for bf16's m16 tiles, 8
    for f32), at most 64 / 32, lowered until the block's shared memory fits. Otherwise the
    row design."""
    del T  # every step is alike; the plan does not depend on the sequence length
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    itemsize = 2 if dtype == torch.bfloat16 else 4
    step, cap = (16, 64) if itemsize == 2 else (8, 32)
    for cluster in (8, 16):
        units = H // cluster
        if H % cluster or units < 8 or units & (units - 1):
            continue
        want = -(-B // MAX_CLUSTERS[cluster])
        for rows in range(min(cap, max(step, -(-want // step) * step)), 0, -step):
            smem = cluster_smem(kind, H, cluster, rows, itemsize)
            if smem <= SMEM_LIMIT:
                return Plan("cluster", cluster, rows, H // cluster, smem, -(-B // rows) * cluster)
    return row_plan(kind, B, H)


def max_active_clusters(kind: str, dtype, plan: Plan) -> int:
    """Clusters of the plan's size and shared memory that the card runs at once
    (cudaOccupancyMaxActiveClusters); the card's counterpart of MAX_CLUSTERS."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return load_library().max_active_clusters(_gates(kind), int(dtype == torch.bfloat16), plan.cluster, plan.smem)


def pack_wh(wh: torch.Tensor, plan: Plan) -> torch.Tensor:
    """wh [H, G*H] -> [cluster, G*U, H]: block r's gate columns g*H + r*U + u (u < U) as rows
    g*U + u, each contiguous along K, which is the layout of the mma's B operand. The row
    design reads wh as it is."""
    if plan.design == "rows":
        return wh
    H = wh.shape[0]
    G = wh.shape[1] // H
    return wh.t().reshape(G, plan.cluster, plan.units, H).transpose(0, 1).reshape(plan.cluster, G * plan.units, H).contiguous()


def unpack_wh(packed: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The inverse of `pack_wh`."""
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


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    """The built library for the current sources and flags (keyed by their hash)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS + list(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"rnn_seq_{digest}.so"


def build(defines: Tuple[str, ...] = ()) -> Path:
    """Compile `csrc/rnn_seq.cu` into `_build/` unless this version is already there; `defines`
    are extra -D flags (the phase clock of `ops/rnn_seq_phases.py`). The compiler's output
    (ptxas register and shared-memory report) goes to a .log beside it."""
    path = library_path(defines)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def load_library(defines: Tuple[str, ...] = ()):
    """Build if needed and load the kernels' shared library (once per process: the first
    call's `defines` hold for the process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(defines)))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.gru_seq_forward.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
            lib.lstm_seq_forward.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
            lib.gru_rows_forward.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
            lib.lstm_rows_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            lib.max_active_clusters.argtypes = [i32] * 4
            for fn in (lib.gru_seq_forward, lib.lstm_seq_forward, lib.gru_rows_forward, lib.lstm_rows_forward,
                       lib.max_active_clusters):
                fn.restype = i32
            _lib = lib
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
    return f"{kind}_seq" if plan.design == "cluster" else f"{kind}_seq_rows"


def _launch(kind, x_proj, state0, resets, wh, bh, plan):
    """Checks, allocates the outputs and launches the planned kernel on the current stream."""
    T, B, H = _check_common(x_proj, _gates(kind))
    G, dev, dt = _gates(kind), x_proj.device, x_proj.dtype
    _check("x_proj", x_proj, (T, B, G * H), dt, dev)
    _check("h0" if kind == "gru" else "hc0", state0, (B, H if kind == "gru" else 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("wh", wh, (H, G * H), dt, dev)
    if kind == "gru":
        _check("bh", bh, (G * H,), dt, dev)
    plan = plan or launch_plan(kind, T, B, H, dt)
    if plan.design == "cluster" and x_proj.data_ptr() % 16:
        x_proj = x_proj.clone()  # a view at an odd offset: the kernel copies x_proj in 16-byte pieces
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
    fn = getattr(lib, f"{kind}_{'seq' if plan.design == 'cluster' else 'rows'}_forward")
    with torch.cuda.device(dev):
        err = fn(*ptrs, *dims, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} (plan {plan})")
    _launches[_kernel_name(kind, plan)] += 1
    return outs, state


def _launch_gru(x_proj, h0, resets, wh, bh, plan=None):
    """`plan` defaults to `launch_plan` of the shape; chip_smoke.py passes the row design's
    plan to time the first design at the main-path shape."""
    return _launch("gru", x_proj, h0, resets, wh, bh, plan)


def _launch_lstm(x_proj, hc0, resets, wh, plan=None):
    return _launch("lstm", x_proj, hc0, resets, wh, None, plan)


def row_plan(kind: str, B: int, H: int) -> Plan:
    """The row design's plan for any shape (what `launch_plan` returns where no cluster fits)."""
    return Plan("rows", 1, ROW_TILE, H, (2 if kind == "gru" else 3) * ROW_TILE * H * 4, -(-B // ROW_TILE))


def _forward(launch, reference, args):
    device = args[0].device
    if device.type == "cuda":
        return launch(*args)
    if device.type == "cpu":
        return reference(*args)
    raise ValueError(f"no RNN sequence implementation for device {device}")


def _recompute_grads(reference, args, needs, grad_outputs):
    """Backward by rematerialization: rerun the plain version under autograd."""
    with torch.enable_grad():
        inputs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
        outputs = reference(*inputs)
        wanted = [i for i, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(outputs, wanted, grad_outputs, allow_unused=True)) if wanted else iter(())
        return tuple(next(grads) if n else None for n in needs)


class GRUSeqFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, h0, resets, wh, bh):
        ctx.save_for_backward(x_proj, h0, resets, wh, bh)
        return _forward(_launch_gru, gru_seq_reference, (x_proj, h0, resets, wh, bh))

    @staticmethod
    def backward(ctx, d_outs, d_h_final):
        args = ctx.saved_tensors
        needs = list(ctx.needs_input_grad)
        needs[2] = False  # resets get no gradient
        return _recompute_grads(gru_seq_reference, args, needs, (d_outs, d_h_final))


class LSTMSeqFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, hc0, resets, wh):
        ctx.save_for_backward(x_proj, hc0, resets, wh)
        return _forward(_launch_lstm, lstm_seq_reference, (x_proj, hc0, resets, wh))

    @staticmethod
    def backward(ctx, d_outs, d_hc_final):
        args = ctx.saved_tensors
        needs = list(ctx.needs_input_grad)
        needs[2] = False
        return _recompute_grads(lstm_seq_reference, args, needs, (d_outs, d_hc_final))


def gru_seq(x_proj, h0, resets, wh, bh):
    """GRU recurrence (see module doc). CUDA: the hand-written kernel; CPU: the plain version."""
    return GRUSeqFunction.apply(x_proj, h0, resets, wh, bh)


def lstm_seq(x_proj, hc0, resets, wh):
    """LSTM recurrence (see module doc). CUDA: the hand-written kernel; CPU: the plain version."""
    return LSTMSeqFunction.apply(x_proj, hc0, resets, wh)


_launches = {"gru_seq": 0, "gru_seq_rows": 0, "lstm_seq": 0, "lstm_seq_rows": 0}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset: "gru_seq"/"lstm_seq" for the cluster
    design, "gru_seq_rows"/"lstm_seq_rows" for the row design."""
    return dict(_launches)
