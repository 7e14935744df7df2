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


# the four shapes of the first design, the default width (rnn_size=512), and a shape whose
# wh slice fits no block of a cluster (the row design)
CARD_SHAPES = [(32, 512, 256), (7, 24, 128), (1, 8, 128), (5, 3, 64), (32, 512, 512), (4, 16, 1024)]


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


# the ViZDoom and DMLab paths' shapes in the dtype each runs, and the design the plan picks: Doom's
# GRU-512 over 2048 / 32 segments (the row design, 16 blocks); the DMLab core's LSTM-256 over 1024 / 32;
# the instruction encoder's LSTM-64 over 16 tokens in a rollout slot of 64 envs, in a minibatch of 1024
# (32 clusters of 8: three waves) and over the 128 envs' last observations
PATH_SHAPES = [("gru", 32, 64, 512, "float32", "rows"), ("lstm", 32, 32, 256, "float32", "cluster"),
               ("lstm", 16, 64, 64, "float32", "cluster"), ("lstm", 16, 1024, 64, "float32", "cluster"),
               ("lstm", 16, 128, 64, "float32", "cluster")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("T,B,H", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, kind, dtype, T, B, H):
    _kernel_matches_plain(cuda_device, kind, dtype, T, B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype,design", PATH_SHAPES)
def test_kernel_matches_plain_on_card_at_the_path_shapes(cuda_device, kind, T, B, H, dtype, design):
    assert cuda_rnn.launch_plan(kind, T, B, H, dtype).design == design
    _kernel_matches_plain(cuda_device, kind, dtype, T, B, H)


@pytest.mark.parametrize("kind,T,B,H,dtype,design", PATH_SHAPES)
def test_path_shapes_take_their_design(kind, T, B, H, dtype, design):
    """H=512 in float32 fits no cluster slice; H=64 takes the smallest slice the cluster design
    allows (8 units a block); every cluster plan fits the card."""
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
    assert plan.design == design
    if design == "cluster":
        assert plan.cluster == 8 and plan.units == H // 8 and plan.rows * (plan.grid // plan.cluster) >= B
    else:
        assert plan == cuda_rnn.row_plan(kind, B, H) and plan.grid == 16


def _kernel_matches_plain(cuda_device, kind, dtype, T, B, H):
    kernel_fn, plain_fn = _fns(kind)
    args = [a.requires_grad_(i != 2) for i, a in enumerate(_inputs(kind, T, B, H, dtype, cuda_device, seed=7))]
    cuda_rnn.reset_launch_counts()
    out, state = kernel_fn(*args)
    torch.cuda.synchronize()
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
    name = f"{kind}_seq" if plan.design == "cluster" else f"{kind}_seq_rows"
    assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, name: 1}
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


def _masked_inputs(kind, T, B, H, dtype, device, seed=11):
    """What a policy's train call on a shared mixed trajectory feeds the recurrence: the other
    policies' slots (here every second row) are invalid for the whole segment, so their
    `resets` are 1 at every step; their inputs are another policy's finite values."""
    args = _inputs(kind, T, B, H, dtype, device, seed=seed)
    args[2][:, 1::2] = 1.0
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_plain_version_on_rows_reset_at_every_step(kind, dtype):
    """The plain versions on the CPU: a row reset at every step gives finite outputs that, from
    step 1 on, depend on that step's input alone (the carry entering it is zero)."""
    T, B, H = 6, 8, 64
    args = _masked_inputs(kind, T, B, H, dtype, "cpu")
    plain_fn = _fns(kind)[1]
    out, state = plain_fn(*args)
    assert torch.isfinite(out).all() and torch.isfinite(state).all() and (state[1::2] == 0).all()
    zero_state = torch.zeros_like(args[1])
    for t in range(1, T):
        step_out, _ = plain_fn(args[0][t:t + 1], zero_state, args[2][t:t + 1], *args[3:])
        assert torch.equal(out[t, 1::2], step_out[0, 1::2])


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["planned", "rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_kernel_on_rows_reset_at_every_step(cuda_device, kind, dtype, design):
    """Both kernels, both designs, at the population paths' widths: rows whose resets are 1 for
    all T come out finite (the loss multiplies them by 0, and 0 * nan is nan) and equal to the
    plain version; a second launch with another `wh` gives that matrix's result, not the first's."""
    T, B, H = 32, 512, 512 if (kind, dtype, design) == ("gru", "bfloat16", "planned") else 256
    args = _masked_inputs(kind, T, B, H, dtype, cuda_device)
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    plan = cuda_rnn.row_plan(kind, B, H) if design == "rows" else cuda_rnn.launch_plan(kind, T, B, H, dtype)
    plain_fn = _fns(kind)[1]
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    other_wh = torch.flip(args[3], dims=(0,)).contiguous()
    with torch.no_grad():
        for wh in (args[3], other_wh):
            call = args[:3] + [wh] + args[4:]
            out, state = launch(*call, plan=plan)
            torch.cuda.synchronize()
            assert torch.isfinite(out).all() and torch.isfinite(state).all() and (state[1::2] == 0).all()
            ref_out, ref_state = plain_fn(*call)
            torch.testing.assert_close(out, ref_out, atol=tol, rtol=0)
            torch.testing.assert_close(state, ref_state, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype", [("gru", 32, 512, 256, "bfloat16"), ("lstm", 32, 128, 256, "float32")])
def test_main_path_clusters_run_in_one_wave(cuda_device, kind, T, B, H, dtype):
    """MAX_CLUSTERS holds on this card: every cluster of a main-path launch runs at once."""
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
    assert plan.grid // plan.cluster <= cuda_rnn.max_active_clusters(kind, dtype, plan)


# ------------------------------------------------------------------ launch plan (CPU)

PLAN_B = [3, 8, 24, 128, 512, 4096]
PLAN_H = [64, 128, 256, 512, 1024]


@pytest.mark.parametrize("H", PLAN_H)
@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_launch_plan_fits_the_card_and_covers_every_unit(kind, dtype, B, H):
    plan = cuda_rnn.launch_plan(kind, 32, B, H, dtype)
    assert plan.smem <= 232_448  # a block's shared memory on the H100
    if plan.design == "cluster":
        assert plan.cluster in (8, 16)  # 16 is launched with the non-portable cluster size allowed
        assert plan.smem == cuda_rnn.cluster_smem(kind, H, plan.cluster, plan.rows, 2 if dtype == "bfloat16" else 4)
        assert plan.units * plan.cluster == H and plan.units >= 8 and plan.units & (plan.units - 1) == 0
        assert plan.rows % (16 if dtype == "bfloat16" else 8) == 0
    else:
        assert plan == cuda_rnn.row_plan(kind, B, H)
        assert plan.smem <= 48 * 1024  # launched without raising the dynamic shared-memory limit
    # the kernels' map from blockIdx to its tile: cluster = block // cluster size, rank = block % cluster size
    owner = np.zeros((B, H), dtype=np.int64)
    for block in range(plan.grid):
        tile, rank = divmod(block, plan.cluster)
        owner[tile * plan.rows:(tile + 1) * plan.rows, rank * plan.units:(rank + 1) * plan.units] += 1
    assert (owner == 1).all(), "every (row, unit) pair belongs to exactly one block"


@pytest.mark.parametrize(
    "kind,T,B,H,dtype",
    [("gru", 32, 512, 256, "bfloat16"), ("lstm", 32, 128, 256, "float32"), ("gru", 32, 512, 512, "bfloat16")],
)
def test_cluster_design_at_the_main_path_shapes(kind, T, B, H, dtype):
    """Both main-path shapes and the default rnn_size=512 in bf16 run the cluster design."""
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
    assert plan.design == "cluster"
    assert plan.grid <= 2 * 132  # at most two waves over the SMs


@pytest.mark.parametrize(
    "kind,H,dtype", [("gru", 1024, "bfloat16"), ("lstm", 512, "float32"), ("gru", 100, "float32"), ("lstm", 192, "bfloat16")]
)
def test_row_design_where_no_cluster_slice_fits(kind, H, dtype):
    assert cuda_rnn.launch_plan(kind, 4, 16, H, dtype).design == "rows"


@pytest.mark.parametrize("H", [64, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_pack_wh_holds_each_blocks_columns(kind, dtype, H):
    G = 3 if kind == "gru" else 4
    plan = cuda_rnn.launch_plan(kind, 8, 64, H, "bfloat16")  # a cluster plan at every H here
    assert plan.design == "cluster"
    wh = _inputs(kind, 1, 1, H, dtype, "cpu")[3]
    packed = cuda_rnn.pack_wh(wh, plan)
    assert packed.shape == (plan.cluster, G * plan.units, H) and packed.is_contiguous()
    for r in range(plan.cluster):
        cols = [g * H + r * plan.units + u for g in range(G) for u in range(plan.units)]
        assert torch.equal(packed[r], wh[:, cols].t())
    assert torch.equal(cuda_rnn.unpack_wh(packed, plan), wh)


def test_pack_wh_leaves_the_row_design_alone():
    plan = cuda_rnn.launch_plan("gru", 4, 16, 1024, "bfloat16")
    wh = torch.zeros(1024, 3 * 1024, dtype=torch.bfloat16)
    assert cuda_rnn.pack_wh(wh, plan) is wh
