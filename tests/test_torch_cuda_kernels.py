"""The CUDA kernels of ops/cuda_rnn.py against their plain versions, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card the `cuda`
tests skip; the others check, on the CPU, that the CUDA path never falls back.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from sample_factory_tpu_torch.ops import cuda_rnn

torch.set_num_threads(1)

# bf16: kernel and plain version round every gate op alike but sum h @ wh in another
# order, so a product can land one bf16 ulp apart, and the flip feeds forward
BF16_ATOL = 0.0625


def _inputs(kind, T, B, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    dt = getattr(torch, dtype)
    args = [
        torch.tensor(rng.normal(size=(T, B, G * H)).astype(np.float32), device=device).to(dt),
        torch.tensor(rng.normal(size=(B, H if kind == "gru" else 2 * H)).astype(np.float32), device=device),
        torch.tensor((rng.random((T, B)) < 0.1).astype(np.float32), device=device),
        torch.tensor((rng.normal(size=(H, G * H)) / math.sqrt(H)).astype(np.float32), device=device).to(dt),
    ]
    if kind == "gru":
        args.append(torch.tensor((rng.normal(size=(G * H,)) * 0.1).astype(np.float32), device=device).to(dt))
    return args


def _fns(kind):
    return (cuda_rnn.gru_seq, cuda_rnn.gru_seq_reference) if kind == "gru" else (cuda_rnn.lstm_seq, cuda_rnn.lstm_seq_reference)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_no_fallback_for_other_devices(kind):
    """Only a CPU tensor takes the plain version; any other device launches or raises."""
    args = _inputs(kind, 2, 3, 64, "float32", "cpu")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no RNN sequence implementation"):
        _fns(kind)[0](*meta)


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.isfile(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        pytest.skip("nvcc is installed here: the build would run")
    if cuda_rnn.library_path().exists():
        pytest.skip("the library is already built")
    with pytest.raises(FileNotFoundError, match="nvcc not found"):
        cuda_rnn.build()


def test_library_path_follows_the_source():
    path = cuda_rnn.library_path()
    assert path.parent == cuda_rnn.BUILD_DIR and path.name.startswith("rnn_seq_") and path.suffix == ".so"
    assert cuda_rnn.SOURCE.is_file()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("T,B,H", [(32, 512, 256), (7, 24, 128), (1, 8, 128), (5, 3, 64)])
def test_kernel_matches_plain_on_card(cuda_device, kind, dtype, T, B, H):
    kernel_fn, plain_fn = _fns(kind)
    args = [a.requires_grad_(i != 2) for i, a in enumerate(_inputs(kind, T, B, H, dtype, cuda_device, seed=7))]
    cuda_rnn.reset_launch_counts()
    out, state = kernel_fn(*args)
    torch.cuda.synchronize()
    assert cuda_rnn.launch_counts()[f"{kind}_seq"] == 1
    ref_out, ref_state = plain_fn(*args)
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(out, ref_out, atol=tol, rtol=0)
    torch.testing.assert_close(state, ref_state, atol=tol, rtol=0)
    wrt = [a for i, a in enumerate(args) if i != 2]
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    for g, r in zip(grads, ref_grads):
        scale = max(1.0, float(r.float().abs().max()))
        assert float((g.float() - r.float()).abs().max()) / scale <= (1e-3 if dtype == "float32" else 4 * BF16_ATOL)
