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
H=256 in bf16, against ~6.4 GFLOP of products). The first design gives each
block a tile of batch rows that it carries through all T steps itself, since
rows are independent; `wh` is re-read from L2 every step. See the source note
in `csrc/rnn_seq.cu`.

Gradients: each kernel sits in a `torch.autograd.Function` whose backward
recomputes through the plain version under autograd. The JAX package has no
backward kernel either (`_bwd`, `_lstm_bwd`: remat through the scan
reference), so this is the same design. `resets` get no gradient.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "rnn_seq.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_HIDDEN = 1024  # shared memory: 3 * 4 rows * H * 4 bytes must stay within the 48 KB static limit

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


# ------------------------------------------------------------------ build and load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA RNN kernels cannot be built")


def library_path() -> Path:
    """The built library for the current sources and flags (keyed by their hash)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"rnn_seq_{digest}.so"


def build() -> Path:
    """Compile `csrc/rnn_seq.cu` into `_build/` unless this version is already there.
    The compiler's output (ptxas register and shared-memory report) goes to a .log beside it."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def load_library():
    """Build if needed and load the kernels' shared library (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.gru_seq_forward.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
            lib.gru_seq_forward.restype = i32
            lib.lstm_seq_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            lib.lstm_seq_forward.restype = i32
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


def _launch_gru(x_proj, h0, resets, wh, bh):
    T, B, H = _check_common(x_proj, 3)
    dev, dt = x_proj.device, x_proj.dtype
    _check("x_proj", x_proj, (T, B, 3 * H), dt, dev)
    _check("h0", h0, (B, H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("wh", wh, (H, 3 * H), dt, dev)
    _check("bh", bh, (3 * H,), dt, dev)
    lib = load_library()
    outs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gru_seq_forward(
            x_proj.data_ptr(), h0.data_ptr(), resets.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            outs.data_ptr(), h_final.data_ptr(), T, B, H, int(dt == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_seq_forward launch failed: CUDA error {err}")
    gru_seq.launches += 1
    return outs, h_final


def _launch_lstm(x_proj, hc0, resets, wh):
    T, B, H = _check_common(x_proj, 4)
    dev, dt = x_proj.device, x_proj.dtype
    _check("x_proj", x_proj, (T, B, 4 * H), dt, dev)
    _check("hc0", hc0, (B, 2 * H), torch.float32, dev)
    _check("resets", resets, (T, B), torch.float32, dev)
    _check("wh", wh, (H, 4 * H), dt, dev)
    lib = load_library()
    outs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    hc_final = torch.empty((B, 2 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_seq_forward(
            x_proj.data_ptr(), hc0.data_ptr(), resets.data_ptr(), wh.data_ptr(),
            outs.data_ptr(), hc_final.data_ptr(), T, B, H, int(dt == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm_seq_forward launch failed: CUDA error {err}")
    lstm_seq.launches += 1
    return outs, hc_final


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


gru_seq.launches = 0
lstm_seq.launches = 0


def reset_launch_counts() -> None:
    gru_seq.launches = 0
    lstm_seq.launches = 0


def launch_counts() -> dict:
    return {"gru_seq": gru_seq.launches, "lstm_seq": lstm_seq.launches}
