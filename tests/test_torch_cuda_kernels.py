"""The CUDA kernels of ops/cuda_rnn.py against their plain versions, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py configures JAX). Without a card the `cuda`
tests skip; the others check, on the CPU, that the CUDA path never falls back.
"""

import contextlib
import dataclasses
import math
import os
import re
import shutil
import subprocess
import types

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


# the paths' shapes in the dtype each runs, and the design the plan picks: GRU-512 float32 (the grid
# design) in Doom's learner over 2048 / 32 segments, on the multichip configuration's gathered `wh` over
# 64 / 16 rows of one data index, and at the cfg's defaults over 1024 / 32; the DMLab core's LSTM-256 over
# 1024 / 32; the instruction encoder's LSTM-64 over 16 tokens in a rollout slot of 64 envs, in a minibatch
# of 1024 and over the 128 envs' last observations (the resident design: its cluster plan, 32 clusters of 8 at 1024, would
# need three waves; at 64 and 128 one wave, slower in turns)
# LSTM-512 float32 (the grid design) in NetHack's learner over 768 / 32 segments
# (a train step takes one rollout of 24 envs) and the 1024 / 32 its defaults name, and in AllegroHandLSTM's
# over 32768 / 16 (4 tiles of 512 rows)
PATH_SHAPES = [("gru", 32, 64, 512, "float32", "grid"), ("gru", 16, 4, 512, "float32", "grid"), ("gru", 32, 32, 512, "float32", "grid"),
               ("lstm", 32, 32, 256, "float32", "cluster"),
               ("lstm", 16, 64, 64, "float32", "resident"), ("lstm", 16, 1024, 64, "float32", "resident"),
               ("lstm", 16, 128, 64, "float32", "resident"), ("lstm", 32, 24, 512, "float32", "grid"),
               ("lstm", 32, 32, 512, "float32", "grid"), ("lstm", 16, 2048, 512, "float32", "grid")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("T,B,H", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, kind, dtype, T, B, H):
    _kernel_matches_plain(cuda_device, kind, dtype, T, B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype,design", PATH_SHAPES)
def test_kernel_matches_plain_on_card_at_the_path_shapes(cuda_device, kind, T, B, H, dtype, design):
    assert cuda_rnn.launch_plan(kind, T, B, H, dtype, cuda_rnn.card_spec(cuda_device)).design == design
    _kernel_matches_plain(cuda_device, kind, dtype, T, B, H)


@pytest.mark.parametrize("kind,T,B,H,dtype,design", PATH_SHAPES)
def test_path_shapes_take_their_design(kind, T, B, H, dtype, design):
    """H=512 in float32 fits no cluster slice: the GRU and the LSTM take the grid design (one batch
    tile of 128 slices of 4 units up to 64 segments, 4 tiles of 32 slices of 16 units at
    AllegroHandLSTM's); the DMLab core's LSTM-256 takes clusters of 8; the LSTM-64 takes the resident design
    (over cluster plans of one wave and of three); every cluster plan fits the card."""
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype)
    assert plan.design == design
    if design == "cluster":
        assert plan.cluster == 8 and plan.units == H // 8 and plan.rows * (plan.grid // plan.cluster) >= B
    elif design == "grid":
        assert plan == cuda_rnn.grid_plan(kind, B, H, dtype) and plan.grid <= cuda_rnn.H100_SXM.sms
        tiles, units = (4, 16) if B >= cuda_rnn.GRID_WIDE_ROWS else (1, 4)
        assert plan.units == units and plan.cluster == H // units and plan.grid == tiles * plan.cluster
        assert plan.rows * tiles >= B > plan.rows * (tiles - 1)
    elif design == "resident":
        assert plan == cuda_rnn.resident_plan(kind, B, H, dtype) and plan.grid <= cuda_rnn.H100_SXM.sms and plan.rows * plan.grid >= B
        assert H <= cuda_rnn.ROWS_OVER_WAVES_MAX_H and cuda_rnn.cluster_plan(kind, B, H, dtype) is not None
    else:
        assert plan == cuda_rnn.row_plan(kind, B, H) and plan.rows == 4 and plan.grid == B // 4
        assert H == 512 or cuda_rnn.cluster_waves(cuda_rnn.cluster_plan(kind, B, H, dtype)) > 1


def _kernel_matches_plain(cuda_device, kind, dtype, T, B, H):
    kernel_fn, plain_fn = _fns(kind)
    args = [a.requires_grad_(i != 2) for i, a in enumerate(_inputs(kind, T, B, H, dtype, cuda_device, seed=7))]
    cuda_rnn.reset_launch_counts()
    out, state = kernel_fn(*args)
    torch.cuda.synchronize()
    name = cuda_rnn._kernel_name(kind, cuda_rnn.launch_plan(kind, T, B, H, dtype, cuda_rnn.card_spec(cuda_device)))
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
@pytest.mark.parametrize(
    "kind,dtype,design",
    [(kind, dtype, design) for design in ("planned", "rows") for dtype in ("float32", "bfloat16") for kind in ("gru", "lstm")]
    + [("lstm", "float32", "grid"), ("gru", "float32", "grid")],
)
def test_kernel_on_rows_reset_at_every_step(cuda_device, kind, dtype, design):
    """Both kernels, every design, at the population paths' widths (the grid design at NetHack's
    learner's, 512 units in float32 over 24 segments): rows whose resets are 1 for all T come out finite
    (the loss multiplies them by 0, and 0 * nan is nan) and equal to the plain version; a second
    launch with another `wh` gives that matrix's result, not the first's."""
    T, B, H = 32, 512, 512 if (kind, dtype, design) == ("gru", "bfloat16", "planned") else 256
    if design == "grid":
        B, H = 24, 512
    args = _masked_inputs(kind, T, B, H, dtype, cuda_device)
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    spec = cuda_rnn.card_spec(cuda_device)
    plan = {"rows": cuda_rnn.row_plan(kind, B, H), "grid": cuda_rnn.grid_plan(kind, B, H, dtype, spec)}.get(
        design, cuda_rnn.launch_plan(kind, T, B, H, dtype, spec))
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
    """The card's spec holds on this card: every cluster of a main-path launch runs at once, and the
    clusters the spec counts at one block an SM run at the plan's shared memory too."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, spec)
    assert plan.grid // plan.cluster <= spec.clusters_at_once(plan.cluster) <= cuda_rnn.max_active_clusters(kind, dtype, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H", [("lstm", 32, 24, 512), ("lstm", 16, 2048, 512), ("gru", 32, 64, 512), ("gru", 16, 4, 512),
                                        ("gru", 32, 32, 512), ("gru", 16, 2048, 512)])
def test_grid_plans_are_resident_at_once(cuda_device, kind, T, B, H):
    """The plan made for this card's spec keeps one block on each SM at most, and every block of the
    grid launches of the NetHack, AllegroHandLSTM and Doom learners, the multichip configuration and
    the defaults is resident at once, as a cooperative launch needs
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the plan's threads and shared memory, for the
    kernel of that kind, times the card's own SM count)."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.launch_plan(kind, T, B, H, "float32", spec)
    assert plan.design == "grid"
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sms == spec.sms and plan.grid <= spec.sms
    assert plan.grid <= cuda_rnn.grid_blocks_per_sm(kind, plan) * sms


@pytest.mark.cuda
def test_gru_grid_design_on_wide_tiles(cuda_device):
    """The GRU's grid design where it takes 8 x 8 register tiles in passes (from GRID_WIDE_ROWS rows on):
    the plan AllegroHandLSTM's LSTM takes on this card (4 batch tiles of 512 rows in 2 passes on the
    H100 SXM)."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.launch_plan("gru", 16, 2048, 512, "float32", spec)
    assert plan.design == "grid" and plan == cuda_rnn.launch_plan("lstm", 16, 2048, 512, "float32", spec)
    assert (plan.tile_rows, plan.tile_cols) == (8, 8) and plan.passes >= 2
    if spec == cuda_rnn.H100_SXM:
        assert plan.passes == 2
    _kernel_matches_plain(cuda_device, "gru", "float32", 16, 2048, 512)


# ------------------------------------------------------------------ launch plan (CPU)

PLAN_B = [3, 8, 24, 128, 512, 4096]
PLAN_H = [64, 128, 256, 512, 1024]


# the cards the planner is held to: the H100 SXM (the case ids of the shapes alone), the H100 PCIe's 114
# SMs in a GPC layout that runs no cluster of 16 and in one that runs 6, and a card of half the SXM's SMs
SMALL_SPECS = {"114-13-0": cuda_rnn.CardSpec(114, 13, 0, 232_448), "114-13-6": cuda_rnn.CardSpec(114, 13, 6, 232_448),
               "66-7-3": cuda_rnn.CardSpec(66, 7, 3, 232_448)}
PLAN_CASES = [pytest.param(kind, dtype, B, H, spec, id=f"{kind}-{dtype}-{B}-{H}" + (f"-{name}" if name else ""))
              for name, spec in {"": cuda_rnn.H100_SXM, **SMALL_SPECS}.items()
              for kind in ("gru", "lstm") for dtype in ("float32", "bfloat16") for B in PLAN_B for H in PLAN_H]


@pytest.mark.parametrize("kind,dtype,B,H,spec", PLAN_CASES)
def test_launch_plan_fits_the_card_and_covers_every_unit(kind, dtype, B, H, spec):
    plan = cuda_rnn.launch_plan(kind, 32, B, H, dtype, spec)
    assert plan.smem <= spec.smem_limit  # a block's shared memory on the card
    if plan.design == "cluster":
        assert plan.cluster in (8, 16)  # 16 is launched with the non-portable cluster size allowed
        assert spec.clusters_at_once(plan.cluster) >= 1  # never a size of which the card runs none
        assert plan == cuda_rnn.cluster_plan(kind, B, H, dtype, spec)
        assert plan.smem == cuda_rnn.cluster_smem(kind, H, plan.cluster, plan.rows, 2 if dtype == "bfloat16" else 4)
        assert plan.units * plan.cluster == H and plan.units >= 8 and plan.units & (plan.units - 1) == 0
        assert plan.rows % (16 if dtype == "bfloat16" else 8) == 0
    elif plan.design == "grid":  # float32 where no cluster slice fits
        assert dtype == "float32" and plan == cuda_rnn.grid_plan(kind, B, H, dtype, spec)
        assert plan.grid <= spec.sms and plan.units * plan.cluster == H  # one block a SM, all resident
        assert plan.threads == cuda_rnn.grid_threads(plan.units, plan.rows, plan.tile_rows, plan.tile_cols, plan.ksplit, plan.passes)
        assert 32 <= plan.threads <= cuda_rnn.grid_max_threads(plan.tile_rows, plan.tile_cols)
        assert plan.smem == cuda_rnn.grid_smem(H, plan.units, plan.rows, plan.tile_rows, plan.tile_cols, plan.ksplit,
                                               plan.kchunk, plan.passes)
        assert plan.rows % (plan.passes * plan.tile_rows) == 0 and H % plan.kchunk == 0 and plan.kchunk % (4 * plan.ksplit) == 0
        assert plan.ksplit == 1 or (plan.passes == 1 and plan.rows * plan.units <= plan.threads)  # a cell a thread
    elif plan.design == "resident":  # the LSTM at a small width, over a cluster plan of one wave or of several
        assert kind == "lstm" and plan == cuda_rnn.resident_plan(kind, B, H, dtype, spec)
        assert H <= cuda_rnn.ROWS_OVER_WAVES_MAX_H and cuda_rnn.cluster_plan(kind, B, H, dtype, spec) is not None
        _check_resident_plan(plan, B, H, dtype, spec, cuda_rnn.resident_smem)
    else:
        assert plan == cuda_rnn.row_plan(kind, B, H)
        assert plan.smem <= 48 * 1024  # launched without raising the dynamic shared-memory limit
        over = cuda_rnn.cluster_plan(kind, B, H, dtype, spec)  # where a cluster slice fits, only over waves at a small width (the GRU)
        assert over is None or (kind == "gru" and H <= cuda_rnn.ROWS_OVER_WAVES_MAX_H and cuda_rnn.cluster_waves(over, spec) > 1)
    # the kernels' map from blockIdx to its tile: cluster = block // cluster size, rank = block % cluster size
    # (grid design: batch tile = block // unit slices, unit slice = block % unit slices)
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
    "kind,H,dtype,design",
    [("gru", 1024, "bfloat16", "rows"), ("lstm", 512, "float32", "grid"), ("gru", 100, "float32", "rows"),
     ("lstm", 192, "bfloat16", "rows"), ("gru", 512, "float32", "grid")],
)
def test_row_design_where_no_cluster_slice_fits(kind, H, dtype, design):
    """Where no cluster slice fits, the float32 GRU and LSTM take the grid design (H a multiple of 64)
    and every other shape the row design."""
    assert cuda_rnn.launch_plan(kind, 4, 16, H, dtype).design == design


@pytest.mark.parametrize("H", [64, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_pack_wh_holds_each_blocks_columns(kind, dtype, H):
    G = 3 if kind == "gru" else 4
    plan = cuda_rnn.cluster_plan(kind, 64, H, "bfloat16")  # a cluster plan at every H here (the LSTM-64 launches the resident design)
    assert plan.design == "cluster"
    wh = _inputs(kind, 1, 1, H, dtype, "cpu")[3]
    packed = cuda_rnn.pack_wh(wh, plan)
    assert packed.shape == (plan.cluster, G * plan.units, H) and packed.is_contiguous()
    for r in range(plan.cluster):
        cols = [g * H + r * plan.units + u for g in range(G) for u in range(plan.units)]
        assert torch.equal(packed[r], wh[:, cols].t())
    assert torch.equal(cuda_rnn.unpack_wh(packed, plan), wh)


# the grid plans at the learners' shapes, one with several batch tiles at a small width, H=1024; for
# both kinds (the LSTM's cases keep their ids), and the GRU's at the multichip configuration's 4 rows
GRID_PACK_SHAPES = [(24, 512), (2048, 512), (37, 64), (2048, 64), (16, 1024)]
GRID_KIND_SHAPES = ([pytest.param("lstm", B, H, id=f"{B}-{H}") for B, H in GRID_PACK_SHAPES]
                    + [pytest.param("gru", B, H, id=f"gru-{B}-{H}") for B, H in GRID_PACK_SHAPES + [(4, 512)]])


@pytest.mark.parametrize("kind,B,H", GRID_KIND_SHAPES)
def test_pack_wh_gives_each_grid_block_its_columns(kind, B, H):
    """The grid design reads slice r's rows of pack_wh: the G*U gate columns g*H + r*U + u of its
    units, each contiguous along K; unpack_wh gives wh back."""
    G = 3 if kind == "gru" else 4
    plan = cuda_rnn.grid_plan(kind, B, H, "float32")
    assert plan is not None and plan.design == "grid"
    wh = _inputs(kind, 1, 1, H, "float32", "cpu")[3]
    packed = cuda_rnn.pack_wh(wh, plan)
    assert packed.shape == (plan.cluster, G * plan.units, H) and packed.is_contiguous()
    for r in range(plan.cluster):
        cols = [g * H + r * plan.units + u for g in range(G) for u in range(plan.units)]
        assert torch.equal(packed[r], wh[:, cols].t())
    assert torch.equal(cuda_rnn.unpack_wh(packed, plan), wh)


@pytest.mark.parametrize("kind,B,H", GRID_KIND_SHAPES)
def test_grid_threads_cover_each_block_once(kind, B, H):
    """The grid kernel's maps, as csrc/rnn_seq.cu writes them: thread tid = (ks * RT + rt) * NCT + ct
    holds rows p0 + rt + i * RT (i < TM) of each pass and accumulator columns j = g * V + v (gate g of
    4, unit ct * V + v), read from shared-memory column jh * 4 * NCT + ct * 4 + e (j = 4 * jh + e) of the
    permuted wh slice, which holds pack_wh's row g * U + u for g < G and zeros for the GRU's fourth gate.
    Every (pass row, gate column, K split) is one thread's, every permuted column one (gate, unit)'s, and
    every K index one split's in each chunk. Where K is split, the thread that owns cell tid (row tid // U,
    unit tid % U) adds, for each of its G gates, the partial sums of that row's and unit's accumulator
    from every split, each once."""
    _check_grid_threads(kind, cuda_rnn.grid_plan(kind, B, H, "float32"), H)


def _check_grid_threads(kind, plan, H):
    G = 3 if kind == "gru" else 4
    TM, TN, U = plan.tile_rows, plan.tile_cols, plan.units
    V, N, KS = TN // 4, 4 * U, plan.ksplit
    NCT, PR = U // V, plan.rows // plan.passes
    RT = PR // TM
    tiles = RT * NCT
    seen = np.zeros((KS, PR, N), dtype=np.int64)
    slot, accumulator = {}, {}
    for tid in range(plan.threads):
        ct, rt, ks = tid % NCT, tid // NCT % RT, tid // (RT * NCT)
        for i in range(TM):
            for j in range(TN):
                g, v = divmod(j, V)
                seen[ks, rt + i * RT, g * U + ct * V + v] += 1
                # the split's partial sum of this accumulator goes to red[tid * TM * TN + i * TN + j]
                accumulator[tid * TM * TN + i * TN + j] = (ks, rt + i * RT, g, ct * V + v)
                p = (j // 4) * 4 * NCT + ct * 4 + j % 4  # where the kernel reads column j's weights
                assert slot.setdefault(p, (g, ct * V + v)) == (g, ct * V + v)
    assert (seen == 1).all()
    # the kernel's fill of the permuted slice: column p holds pack_wh's row g * U + u, or zeros (g >= G)
    rows_read = []
    for p in range(N):
        jh, c, e = p // (4 * NCT), p % (4 * NCT) // 4, p % 4
        j = jh * 4 + e
        g, u = j // V, c * V + j % V
        assert slot[p] == (g, u)
        if g < G:
            rows_read.append(g * U + u)
    assert sorted(rows_read) == list(range(G * U))
    L = plan.kchunk // KS
    ks_of_k = [(k % plan.kchunk) // L for k in range(H)]
    assert np.bincount(ks_of_k, minlength=KS).tolist() == [H // KS] * KS
    if KS > 1:  # the split path: a cell a thread, its partial sums read back from shared memory
        assert plan.passes == 1 and plan.rows * U <= plan.threads
        for tid in range(plan.rows * U):
            row, u = divmod(tid, U)
            base = (row % RT * NCT + u // V) * TM * TN + row // RT * TN + u % V
            for g in range(G):
                reads = [accumulator[s * tiles * TM * TN + base + g * V] for s in range(KS)]
                assert reads == [(s, row, g, u) for s in range(KS)]


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_design_where_the_cluster_plan_needs_waves_at_a_small_width(kind, dtype):
    """At H <= ROWS_OVER_WAVES_MAX_H a cluster plan of more than one wave gives way to the row design for the GRU and
    to the resident design for the LSTM (the DMLab instruction encoder's (16, 1024, 64) float32 minibatch among them); the
    LSTM's takes the resident design over a cluster plan of one wave too, at any B (DMLab's rollout slot and last-value
    pass among them); the GRU's cluster plan of one wave there, and one of several waves at a wider H, stays."""
    for B in (8, 24, 64, 128, 512, 1024, 2048, 4096):
        for H in (64, 128, 256):
            over, plan = cuda_rnn.cluster_plan(kind, B, H, dtype), cuda_rnn.launch_plan(kind, 16, B, H, dtype)
            assert over is not None
            small = H <= cuda_rnn.ROWS_OVER_WAVES_MAX_H
            if small and kind == "lstm":
                assert plan == cuda_rnn.resident_plan(kind, B, H, dtype)
            elif small and cuda_rnn.cluster_waves(over) > 1:
                assert plan == cuda_rnn.row_plan(kind, B, H)
            else:
                assert plan == over
    assert cuda_rnn.launch_plan("lstm", 16, 1024, 64, "float32").design == "resident"
    assert cuda_rnn.launch_plan("gru", 16, 1024, 64, "float32").design == "rows"
    assert cuda_rnn.cluster_waves(cuda_rnn.cluster_plan("lstm", 1024, 64, "float32")) == 3
    assert cuda_rnn.launch_plan("lstm", 16, 128, 64, "float32").design == "resident"
    assert cuda_rnn.launch_plan("lstm", 16, 24, 64, "float32").design == "resident"


def test_pack_wh_leaves_the_row_design_alone():
    plan = cuda_rnn.launch_plan("gru", 4, 16, 1024, "bfloat16")
    wh = torch.zeros(1024, 3 * 1024, dtype=torch.bfloat16)
    assert cuda_rnn.pack_wh(wh, plan) is wh


# ------------------------------------------------------------------ the card's spec (CPU)

# the plans that ops/cuda_rnn.py made before it read the card (module constants: 132 SMs, 15 clusters of 8 and 7
# of 16 at once, 232,448 B a block), at every shape of PLAN_B x PLAN_H: (design, cluster, rows, units, smem,
# grid[, tile_rows, tile_cols, ksplit, kchunk, passes, threads]); the LSTM-64's row plans over cluster plans of
# several waves, and its cluster plans of one wave, became resident plans when the resident design came
PARENT_PLANS = {
    ("gru", "float32", 3, 64): ('cluster', 8, 8, 8, 14112, 8),
    ("gru", "float32", 3, 128): ('cluster', 8, 8, 16, 40192, 8),
    ("gru", "float32", 3, 256): ('cluster', 8, 8, 32, 129216, 8),
    ("gru", "float32", 3, 512): ('grid', 128, 4, 4, 39040, 128, 4, 4, 8, 128, 1, 32),
    ("gru", "float32", 3, 1024): ('grid', 128, 4, 8, 139392, 128, 4, 4, 8, 128, 1, 64),
    ("gru", "float32", 8, 64): ('cluster', 8, 8, 8, 14112, 8),
    ("gru", "float32", 8, 128): ('cluster', 8, 8, 16, 40192, 8),
    ("gru", "float32", 8, 256): ('cluster', 8, 8, 32, 129216, 8),
    ("gru", "float32", 8, 512): ('grid', 128, 8, 4, 45312, 128, 4, 4, 8, 128, 1, 64),
    ("gru", "float32", 8, 1024): ('grid', 128, 8, 8, 147712, 128, 4, 4, 8, 128, 1, 128),
    ("gru", "float32", 24, 64): ('cluster', 8, 8, 8, 14112, 24),
    ("gru", "float32", 24, 128): ('cluster', 8, 8, 16, 40192, 24),
    ("gru", "float32", 24, 256): ('cluster', 8, 8, 32, 129216, 24),
    ("gru", "float32", 24, 512): ('grid', 128, 24, 4, 70400, 128, 4, 4, 8, 128, 1, 192),
    ("gru", "float32", 24, 1024): ('grid', 128, 24, 8, 180992, 128, 4, 4, 8, 128, 1, 384),
    ("gru", "float32", 128, 64): ('cluster', 8, 16, 8, 21600, 64),
    ("gru", "float32", 128, 128): ('cluster', 8, 16, 16, 54848, 64),
    ("gru", "float32", 128, 256): ('cluster', 8, 16, 32, 158208, 64),
    ("gru", "float32", 128, 512): ('grid', 128, 128, 4, 200704, 128, 4, 4, 4, 128, 1, 512),
    ("gru", "float32", 128, 1024): ('grid', 128, 128, 8, 200704, 128, 4, 4, 1, 64, 1, 256),
    ("gru", "float32", 512, 64): ('rows', 1, 4, 64, 2048, 128),
    ("gru", "float32", 512, 128): ('cluster', 8, 32, 16, 84160, 128),
    ("gru", "float32", 512, 256): ('cluster', 8, 32, 32, 216192, 128),
    ("gru", "float32", 512, 512): ('grid', 128, 512, 4, 180224, 128, 4, 4, 1, 32, 1, 512),
    ("gru", "float32", 512, 1024): ('grid', 128, 512, 8, 204800, 128, 4, 4, 1, 32, 2, 512),
    ("gru", "float32", 4096, 64): ('rows', 1, 4, 64, 2048, 1024),
    ("gru", "float32", 4096, 128): ('cluster', 8, 32, 16, 84160, 1024),
    ("gru", "float32", 4096, 256): ('cluster', 8, 32, 32, 216192, 1024),
    ("gru", "float32", 4096, 512): ('grid', 32, 1024, 16, 204800, 128, 8, 8, 1, 32, 4, 256),
    ("gru", "float32", 4096, 1024): ('rows', 1, 4, 1024, 32768, 1024),
    ("gru", "bfloat16", 3, 64): ('cluster', 8, 16, 8, 11360, 8),
    ("gru", "bfloat16", 3, 128): ('cluster', 8, 16, 16, 28224, 8),
    ("gru", "bfloat16", 3, 256): ('cluster', 8, 16, 32, 80384, 8),
    ("gru", "bfloat16", 3, 512): ('cluster', 16, 16, 32, 145920, 16),
    ("gru", "bfloat16", 3, 1024): ('rows', 1, 4, 1024, 32768, 1),
    ("gru", "bfloat16", 8, 64): ('cluster', 8, 16, 8, 11360, 8),
    ("gru", "bfloat16", 8, 128): ('cluster', 8, 16, 16, 28224, 8),
    ("gru", "bfloat16", 8, 256): ('cluster', 8, 16, 32, 80384, 8),
    ("gru", "bfloat16", 8, 512): ('cluster', 16, 16, 32, 145920, 16),
    ("gru", "bfloat16", 8, 1024): ('rows', 1, 4, 1024, 32768, 2),
    ("gru", "bfloat16", 24, 64): ('cluster', 8, 16, 8, 11360, 16),
    ("gru", "bfloat16", 24, 128): ('cluster', 8, 16, 16, 28224, 16),
    ("gru", "bfloat16", 24, 256): ('cluster', 8, 16, 32, 80384, 16),
    ("gru", "bfloat16", 24, 512): ('cluster', 16, 16, 32, 145920, 32),
    ("gru", "bfloat16", 24, 1024): ('rows', 1, 4, 1024, 32768, 6),
    ("gru", "bfloat16", 128, 64): ('cluster', 8, 16, 8, 11360, 64),
    ("gru", "bfloat16", 128, 128): ('cluster', 8, 16, 16, 28224, 64),
    ("gru", "bfloat16", 128, 256): ('cluster', 8, 16, 32, 80384, 64),
    ("gru", "bfloat16", 128, 512): ('cluster', 16, 32, 32, 191616, 64),
    ("gru", "bfloat16", 128, 1024): ('rows', 1, 4, 1024, 32768, 32),
    ("gru", "bfloat16", 512, 64): ('cluster', 8, 48, 8, 26976, 88),
    ("gru", "bfloat16", 512, 128): ('cluster', 8, 48, 16, 58176, 88),
    ("gru", "bfloat16", 512, 256): ('cluster', 8, 48, 32, 139008, 88),
    ("gru", "bfloat16", 512, 512): ('cluster', 16, 32, 32, 191616, 256),
    ("gru", "bfloat16", 512, 1024): ('rows', 1, 4, 1024, 32768, 128),
    ("gru", "bfloat16", 4096, 64): ('rows', 1, 4, 64, 2048, 1024),
    ("gru", "bfloat16", 4096, 128): ('cluster', 8, 64, 16, 73152, 512),
    ("gru", "bfloat16", 4096, 256): ('cluster', 8, 64, 32, 168320, 512),
    ("gru", "bfloat16", 4096, 512): ('cluster', 16, 32, 32, 191616, 2048),
    ("gru", "bfloat16", 4096, 1024): ('rows', 1, 4, 1024, 32768, 1024),
    ("lstm", "float32", 3, 64): ('resident', 1, 1, 64, 66048, 3, 1, 0, 1, 0, 1, 64),
    ("lstm", "float32", 3, 128): ('cluster', 8, 8, 16, 51008, 8),
    ("lstm", "float32", 3, 256): ('cluster', 8, 8, 32, 167232, 8),
    ("lstm", "float32", 3, 512): ('grid', 128, 4, 4, 39040, 128, 4, 4, 8, 128, 1, 32),
    ("lstm", "float32", 3, 1024): ('grid', 128, 4, 8, 139392, 128, 4, 4, 8, 128, 1, 64),
    ("lstm", "float32", 8, 64): ('resident', 1, 1, 64, 66048, 8, 1, 0, 1, 0, 1, 64),
    ("lstm", "float32", 8, 128): ('cluster', 8, 8, 16, 51008, 8),
    ("lstm", "float32", 8, 256): ('cluster', 8, 8, 32, 167232, 8),
    ("lstm", "float32", 8, 512): ('grid', 128, 8, 4, 45312, 128, 4, 4, 8, 128, 1, 64),
    ("lstm", "float32", 8, 1024): ('grid', 128, 8, 8, 147712, 128, 4, 4, 8, 128, 1, 128),
    ("lstm", "float32", 24, 64): ('resident', 1, 1, 64, 66048, 24, 1, 0, 1, 0, 1, 64),
    ("lstm", "float32", 24, 128): ('cluster', 8, 8, 16, 51008, 24),
    ("lstm", "float32", 24, 256): ('cluster', 8, 8, 32, 167232, 24),
    ("lstm", "float32", 24, 512): ('grid', 128, 24, 4, 70400, 128, 4, 4, 8, 128, 1, 192),
    ("lstm", "float32", 24, 1024): ('grid', 128, 24, 8, 180992, 128, 4, 4, 8, 128, 1, 384),
    ("lstm", "float32", 128, 64): ('resident', 1, 1, 64, 66048, 128, 1, 0, 1, 0, 1, 64),
    ("lstm", "float32", 128, 128): ('cluster', 8, 16, 16, 68224, 64),
    ("lstm", "float32", 128, 256): ('cluster', 8, 16, 32, 201344, 64),
    ("lstm", "float32", 128, 512): ('grid', 128, 128, 4, 200704, 128, 4, 4, 4, 128, 1, 512),
    ("lstm", "float32", 128, 1024): ('grid', 128, 128, 8, 200704, 128, 4, 4, 1, 64, 1, 256),
    ("lstm", "float32", 512, 64): ('resident', 1, 4, 64, 67584, 128, 2, 0, 1, 0, 1, 128),
    ("lstm", "float32", 512, 128): ('cluster', 8, 32, 16, 102656, 128),
    ("lstm", "float32", 512, 256): ('cluster', 8, 16, 32, 201344, 256),
    ("lstm", "float32", 512, 512): ('grid', 128, 512, 4, 180224, 128, 4, 4, 1, 32, 1, 512),
    ("lstm", "float32", 512, 1024): ('grid', 128, 512, 8, 204800, 128, 4, 4, 1, 32, 2, 512),
    ("lstm", "float32", 4096, 64): ('resident', 1, 32, 64, 81920, 128, 4, 0, 1, 0, 1, 512),
    ("lstm", "float32", 4096, 128): ('cluster', 8, 32, 16, 102656, 1024),
    ("lstm", "float32", 4096, 256): ('cluster', 8, 16, 32, 201344, 2048),
    ("lstm", "float32", 4096, 512): ('grid', 32, 1024, 16, 204800, 128, 8, 8, 1, 32, 4, 256),
    ("lstm", "float32", 4096, 1024): ('rows', 1, 4, 1024, 49152, 1024),
    ("lstm", "bfloat16", 3, 64): ('resident', 1, 1, 64, 66048, 3, 1, 0, 1, 0, 1, 64),
    ("lstm", "bfloat16", 3, 128): ('cluster', 8, 16, 16, 35456, 8),
    ("lstm", "bfloat16", 3, 256): ('cluster', 8, 16, 32, 103040, 8),
    ("lstm", "bfloat16", 3, 512): ('cluster', 16, 16, 32, 184960, 16),
    ("lstm", "bfloat16", 3, 1024): ('rows', 1, 4, 1024, 49152, 1),
    ("lstm", "bfloat16", 8, 64): ('resident', 1, 1, 64, 66048, 8, 1, 0, 1, 0, 1, 64),
    ("lstm", "bfloat16", 8, 128): ('cluster', 8, 16, 16, 35456, 8),
    ("lstm", "bfloat16", 8, 256): ('cluster', 8, 16, 32, 103040, 8),
    ("lstm", "bfloat16", 8, 512): ('cluster', 16, 16, 32, 184960, 16),
    ("lstm", "bfloat16", 8, 1024): ('rows', 1, 4, 1024, 49152, 2),
    ("lstm", "bfloat16", 24, 64): ('resident', 1, 1, 64, 66048, 24, 1, 0, 1, 0, 1, 64),
    ("lstm", "bfloat16", 24, 128): ('cluster', 8, 16, 16, 35456, 16),
    ("lstm", "bfloat16", 24, 256): ('cluster', 8, 16, 32, 103040, 16),
    ("lstm", "bfloat16", 24, 512): ('cluster', 16, 16, 32, 184960, 32),
    ("lstm", "bfloat16", 24, 1024): ('rows', 1, 4, 1024, 49152, 6),
    ("lstm", "bfloat16", 128, 64): ('resident', 1, 1, 64, 66048, 128, 1, 0, 1, 0, 1, 64),
    ("lstm", "bfloat16", 128, 128): ('cluster', 8, 16, 16, 35456, 64),
    ("lstm", "bfloat16", 128, 256): ('cluster', 8, 16, 32, 103040, 64),
    ("lstm", "bfloat16", 128, 512): ('cluster', 16, 16, 32, 184960, 128),
    ("lstm", "bfloat16", 128, 1024): ('rows', 1, 4, 1024, 49152, 32),
    ("lstm", "bfloat16", 512, 64): ('resident', 1, 4, 64, 67584, 128, 2, 0, 1, 0, 1, 128),
    ("lstm", "bfloat16", 512, 128): ('cluster', 8, 48, 16, 71552, 88),
    ("lstm", "bfloat16", 512, 256): ('cluster', 8, 48, 32, 173952, 88),
    ("lstm", "bfloat16", 512, 512): ('cluster', 16, 16, 32, 184960, 512),
    ("lstm", "bfloat16", 512, 1024): ('rows', 1, 4, 1024, 49152, 128),
    ("lstm", "bfloat16", 4096, 64): ('resident', 1, 32, 64, 81920, 128, 4, 0, 1, 0, 1, 512),
    ("lstm", "bfloat16", 4096, 128): ('cluster', 8, 64, 16, 89600, 512),
    ("lstm", "bfloat16", 4096, 256): ('cluster', 8, 64, 32, 209408, 512),
    ("lstm", "bfloat16", 4096, 512): ('cluster', 16, 16, 32, 184960, 4096),
    ("lstm", "bfloat16", 4096, 1024): ('rows', 1, 4, 1024, 49152, 1024),
}


@pytest.mark.parametrize("kind,dtype,B,H", list(PARENT_PLANS))
def test_h100_sxm_plans_are_the_plans_made_before_the_card_was_read(kind, dtype, B, H):
    """At H100_SXM (and with no spec named) every shape of the grid gets the plan it had when the planner read
    module constants: reading the card changes nothing on the H100 SXM."""
    plan = cuda_rnn.launch_plan(kind, 32, B, H, dtype, cuda_rnn.H100_SXM)
    assert plan == cuda_rnn.Plan(*PARENT_PLANS[kind, dtype, B, H])
    assert cuda_rnn.launch_plan(kind, 32, B, H, dtype) == plan


# the paths' sites (PERF.md's kernel table) and the plans they had before the card was read, which H100_SXM keeps:
# the float32 H=512 grid sites (Doom, tp (b), the defaults; NetHack's at 24 and 32 segments, AllegroHandLSTM's),
# the cluster sites (main, lstm, selfplay, DMLab's core, dp_host's GRU-256 row counts, host_rnn) and DMLab's instruction
# encoder on the resident design (the cluster design in a rollout slot and the last-value pass, the row design over a
# minibatch, before it came); the waves of each cluster plan
SITE_PLANS = [
    (("gru", 32, 64, 512, "float32"), ("grid", 128, 64, 4, 133120, 128, 4, 4, 8, 128, 1, 512), None),
    (("gru", 16, 4, 512, "float32"), ("grid", 128, 4, 4, 39040, 128, 4, 4, 8, 128, 1, 32), None),
    (("gru", 32, 32, 512, "float32"), ("grid", 128, 32, 4, 82944, 128, 4, 4, 8, 128, 1, 256), None),
    (("lstm", 32, 24, 512, "float32"), ("grid", 128, 24, 4, 70400, 128, 4, 4, 8, 128, 1, 192), None),
    (("lstm", 32, 32, 512, "float32"), ("grid", 128, 32, 4, 82944, 128, 4, 4, 8, 128, 1, 256), None),
    (("lstm", 16, 2048, 512, "float32"), ("grid", 32, 512, 16, 204800, 128, 8, 8, 1, 32, 2, 256), None),
    (("gru", 32, 512, 256, "bfloat16"), ("cluster", 8, 48, 32, 139008, 88), 1),
    (("lstm", 32, 128, 256, "float32"), ("cluster", 8, 16, 32, 201344, 64), 1),
    (("gru", 32, 512, 512, "bfloat16"), ("cluster", 16, 32, 32, 191616, 256), 3),
    (("lstm", 32, 32, 256, "float32"), ("cluster", 8, 8, 32, 167232, 32), 1),
    (("lstm", 16, 64, 64, "float32"), ("resident", 1, 1, 64, 66048, 64, 1, 0, 1, 0, 1, 64), None),
    (("lstm", 16, 1024, 64, "float32"), ("resident", 1, 8, 64, 69632, 128, 4, 0, 1, 0, 1, 128), None),
    (("lstm", 16, 128, 64, "float32"), ("resident", 1, 1, 64, 66048, 128, 1, 0, 1, 0, 1, 64), None),
    (("gru", 32, 128, 256, "float32"), ("cluster", 8, 16, 32, 158208, 64), 1),
    (("gru", 32, 131, 256, "float32"), ("cluster", 8, 16, 32, 158208, 72), 1),
    (("gru", 32, 37, 256, "float32"), ("cluster", 8, 8, 32, 129216, 40), 1),
    (("gru", 32, 255, 256, "float32"), ("cluster", 8, 24, 32, 187200, 88), 1),
    (("gru", 32, 256, 256, "bfloat16"), ("cluster", 8, 32, 32, 109696, 64), 1),
]
SITE_IDS = ["-".join(map(str, shape)) for shape, _, _ in SITE_PLANS]
GRID_SITE_SHAPES = [shape for shape, plan, _ in SITE_PLANS if plan[0] == "grid"]


@pytest.mark.parametrize("shape,fields,waves", SITE_PLANS, ids=SITE_IDS)
def test_h100_sxm_keeps_each_sites_plan(shape, fields, waves):
    plan = cuda_rnn.launch_plan(*shape, cuda_rnn.H100_SXM)
    assert plan == cuda_rnn.Plan(*fields)
    if waves is not None:
        assert cuda_rnn.cluster_waves(plan, cuda_rnn.H100_SXM) == waves


# the grid sites' blocks on the smaller cards: 114 SMs take 3 batch tiles of 32 slices of 16 units (96 blocks)
# where there are rows enough (128 slices of 4 no longer fit), 2 slices' worth of 32 at 4 rows (64 slices of 8);
# 66 SMs take 64 blocks everywhere
SMALL_GRID_BLOCKS = {"114-13-0": [96, 64, 96, 96, 96, 96], "66-7-3": [64, 64, 64, 64, 64, 64]}


@pytest.mark.parametrize("name", list(SMALL_GRID_BLOCKS))
@pytest.mark.parametrize("i", range(len(GRID_SITE_SHAPES)), ids=[SITE_IDS[i] for i in range(len(GRID_SITE_SHAPES))])
def test_smaller_cards_fill_their_sms_at_the_grid_sites(i, name):
    """A card of fewer SMs gets a grid plan of at most one block an SM at every grid site, with as many
    blocks as the search finds (never fewer than half the SMs here), whose threads cover each block once."""
    spec, shape = SMALL_SPECS[name], GRID_SITE_SHAPES[i]
    plan = cuda_rnn.launch_plan(*shape, spec)
    assert plan.design == "grid" and plan.grid == SMALL_GRID_BLOCKS[name][i] <= spec.sms
    _check_grid_threads(shape[0], plan, shape[3])


def test_allegro_site_fills_a_114_sm_card():
    """AllegroHandLSTM's (16, 2048, 512) on 114 SMs: rows stepped by passes x tile height find 3 tiles of
    704 rows x 32 slices of 16 units in 4 passes (96 blocks), where rows stepped by the tile height alone
    (688) fit no pass count and the search fell back to 64 blocks of 8 units."""
    plan = cuda_rnn.grid_plan("lstm", 2048, 512, "float32", SMALL_SPECS["114-13-0"])
    assert plan == cuda_rnn.Plan("grid", 32, 704, 16, 226816, 96, 8, 8, 1, 64, 4, 176)


@pytest.mark.parametrize("name", list(SMALL_SPECS))
def test_cluster_plans_never_use_a_size_the_card_runs_none_of(name):
    """The selfplay path's (32, 512, 512) bf16 takes clusters of 16 where the card runs some (in waves over
    them), and the row design where it runs none; the other cluster sites keep clusters of 8 on every spec, in
    one wave unless a cluster can take no more rows (64 in bf16, 32 in float32, or what its shared memory holds)."""
    spec = SMALL_SPECS[name]
    plan = cuda_rnn.launch_plan("gru", 32, 512, 512, "bfloat16", spec)
    if spec.clusters_of_16 == 0:
        assert cuda_rnn.cluster_plan("gru", 512, 512, "bfloat16", spec) is None and plan == cuda_rnn.row_plan("gru", 512, 512)
    else:
        assert plan.design == "cluster" and plan.cluster == 16
        assert cuda_rnn.cluster_waves(plan, spec) == -(-(plan.grid // 16) // spec.clusters_of_16)
    for shape, fields, waves in SITE_PLANS:
        if waves == 1 and shape[3] > cuda_rnn.ROWS_OVER_WAVES_MAX_H:
            plan = cuda_rnn.launch_plan(*shape, spec)
            assert plan.design == "cluster" and plan.cluster == 8
            kind, _, _, H, dtype = shape
            step, cap, itemsize = (16, 64, 2) if dtype == "bfloat16" else (8, 32, 4)
            assert cuda_rnn.cluster_waves(plan, spec) == 1 or plan.rows == cap or \
                cuda_rnn.cluster_smem(kind, H, 8, plan.rows + step, itemsize) > spec.smem_limit


def _check_resident_plan(plan, B, H, dtype, spec, smem_of):
    """A resident plan (`smem_of`: the forward's or the backward's formula): one block of `rows` rows and all H units, rows a
    power of two, the fewest that keep the blocks in one wave (ceil(B / rows) <= spec.sms) unless the block's threads or
    shared memory hold them lower; resident_rows_a_thread rows a thread, 4 warps at least where the rows allow; shared
    memory by the kernel's formula within the card's limit; the dtype changes none of it."""
    R, rt = plan.rows, plan.tile_rows
    assert plan.design == "resident" and (plan.cluster, plan.units) == (1, H) and R & (R - 1) == 0 and plan.grid == -(-B // R)
    assert rt == cuda_rnn.resident_rows_a_thread(R, H) and R % rt == 0 and plan.threads == R // rt * H <= cuda_rnn.RESIDENT_MAX_THREADS
    assert plan.threads >= min(cuda_rnn.RESIDENT_MIN_THREADS, R * H)
    assert plan.smem == smem_of(H, R) <= spec.smem_limit
    assert plan == cuda_rnn.resident_plan("lstm", B, H, "bfloat16" if dtype == "float32" else "float32", spec, smem_of == cuda_rnn.resident_bwd_smem)
    more = 2 * R
    assert plan.grid <= spec.sms or more // cuda_rnn.resident_rows_a_thread(more, H) * H > cuda_rnn.RESIDENT_MAX_THREADS or \
        smem_of(H, more) > spec.smem_limit
    assert R == 1 or -(-B // (R // 2)) > spec.sms  # fewer rows would need a second wave


def _fake_cuda(monkeypatch, calls):
    """No card here: torch.cuda's device context and stream, and the library's entries, stand in."""
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda _=None: types.SimpleNamespace(cuda_stream=0))

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn

    lib = types.SimpleNamespace(**{name: entry(name) for name in ("gru_grid_forward", "lstm_grid_forward", "gru_seq_forward",
                                                                  "lstm_seq_forward", "gru_rows_forward", "lstm_rows_forward",
                                                                  "gru_seq_backward", "lstm_seq_backward", "gru_seq_grid_backward",
                                                                  "lstm_seq_grid_backward", "gru_seq_cluster_backward",
                                                                  "lstm_seq_cluster_backward", "lstm_resident_forward",
                                                                  "lstm_seq_resident_backward", "lstm_resident_in_forward",
                                                                  "lstm_seq_resident_in_backward")})
    lib.max_active_clusters = lambda gates, is_bf16, size, smem: {8: 13, 16: 0}[size]
    monkeypatch.setattr(cuda_rnn, "load_library", lambda defines=(): lib)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_launch_plans_with_the_spec_of_the_tensors_device(monkeypatch, kind):
    """`_launch` asks card_spec for the device x_proj lies on and launches the plan for that spec: the grid
    design's dims at (32, 64, 512) are the 114-SM plan's, not the H100 SXM's."""
    calls, asked = [], []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["114-13-0"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: asked.append(device) or spec)
    args = _inputs(kind, 2, 64, 512, "float32", "cpu")
    before = cuda_rnn.launch_counts()
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    out, state = launch(*args)
    plan = cuda_rnn.launch_plan(kind, 2, 64, 512, "float32", spec)
    assert asked == [args[0].device] and plan != cuda_rnn.launch_plan(kind, 2, 64, 512, "float32")
    (name, call), = calls
    assert name == f"{kind}_grid_forward" and out.shape == (2, 64, 512) and state.shape == args[1].shape
    assert list(call[-13:-1]) == [2, 64, 512, plan.units, plan.rows, plan.tile_rows, plan.tile_cols, plan.ksplit, plan.kchunk,
                                  plan.passes, plan.threads, plan.smem]
    assert cuda_rnn.launch_counts()[f"{kind}_seq_grid"] == before[f"{kind}_seq_grid"] + 1
    cuda_rnn._launches[f"{kind}_seq_grid"] -= 1


def test_a_refused_launch_names_the_plan_and_the_sms(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    lib = cuda_rnn.load_library()
    lib.gru_grid_forward = lambda *args: 720  # cudaErrorCooperativeLaunchTooLarge
    lib.gru_grid_forward.__name__ = "gru_grid_forward"
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: SMALL_SPECS["66-7-3"])
    with pytest.raises(RuntimeError, match=r"CUDA error 720 \(plan Plan\(design='grid'.*on a card of 66 SMs"):
        cuda_rnn._launch_gru(*_inputs("gru", 2, 64, 512, "float32", "cpu"))


def test_card_spec_reads_each_device_once(monkeypatch):
    """card_spec reads the SMs and the opt-in shared memory from the device's properties and the clusters of 8
    and 16 from cudaOccupancyMaxActiveClusters at that limit (one block an SM), once per device index."""
    calls, props = [], []
    _fake_cuda(monkeypatch, calls)

    def properties(index):
        props.append(index)
        return types.SimpleNamespace(multi_processor_count=114, shared_memory_per_block_optin=232_448)

    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    cuda_rnn._card_spec.cache_clear()
    try:
        spec = cuda_rnn.card_spec(torch.device("cuda", 3))
        assert spec == cuda_rnn.CardSpec(114, 13, 0, 232_448) and spec.clusters_at_once(8) == 13
        assert cuda_rnn.card_spec(3) is spec and cuda_rnn.card_spec("cuda:3") is spec and props == [3]
    finally:
        cuda_rnn._card_spec.cache_clear()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cuda_rnn.card_spec(torch.device("cpu"))


@pytest.mark.parametrize("name", ["114-13-0", "66-7-3"])
@pytest.mark.parametrize("i", range(len(GRID_SITE_SHAPES)), ids=[SITE_IDS[i] for i in range(len(GRID_SITE_SHAPES))])
def test_pack_wh_gives_each_grid_block_of_a_smaller_card_its_columns(i, name):
    kind, _, B, H, _ = GRID_SITE_SHAPES[i]
    plan = cuda_rnn.grid_plan(kind, B, H, "float32", SMALL_SPECS[name])
    G = 3 if kind == "gru" else 4
    wh = _inputs(kind, 1, 1, H, "float32", "cpu")[3]
    packed = cuda_rnn.pack_wh(wh, plan)
    assert packed.shape == (plan.cluster, G * plan.units, H)
    assert torch.equal(packed[1], wh[:, [g * H + plan.units + u for g in range(G) for u in range(plan.units)]].t())
    assert torch.equal(cuda_rnn.unpack_wh(packed, plan), wh)


# ------------------------------------------------------------------ the card's spec (card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["114-13-0", "66-7-3"])
@pytest.mark.parametrize("i", range(len(GRID_SITE_SHAPES)), ids=[SITE_IDS[i] for i in range(len(GRID_SITE_SHAPES))])
def test_smaller_cards_grid_plans_match_plain_on_card(cuda_device, i, name):
    """The plans made for 114 and 66 SMs at every grid site, launched on this card, against the plain
    version at the forward tolerance of the other card tests, twice in a row (the second launch reuses the
    configuration checked by the first)."""
    kind, T, B, H, dtype = GRID_SITE_SHAPES[i]
    plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, SMALL_SPECS[name])
    assert plan.design == "grid" and plan.grid <= torch.cuda.get_device_properties(cuda_device).multi_processor_count
    args = _inputs(kind, T, B, H, dtype, cuda_device, seed=5)
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    tol = 1e-4 * max(1, T // 4)
    with torch.no_grad():
        ref_out, ref_state = _fns(kind)[1](*args)
        for _ in range(2):
            out, state = launch(*args, plan=plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref_out, atol=tol, rtol=0)
            torch.testing.assert_close(state, ref_state, atol=tol, rtol=0)


@pytest.mark.cuda
def test_a_plan_the_card_cannot_hold_at_once_is_refused(cuda_device):
    """A grid plan made for a card of twice this card's SMs, at a shared memory that holds one block an SM,
    is refused before launch (cudaErrorCooperativeLaunchTooLarge), not run and not replaced."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.grid_plan("lstm", 2048, 512, "float32", dataclasses.replace(spec, sms=2 * spec.sms))
    assert plan.grid > spec.sms and cuda_rnn.grid_blocks_per_sm("lstm", plan) == 1
    args = _inputs("lstm", 2, 2048, 512, "float32", cuda_device)
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        cuda_rnn._launch_lstm(*args, plan=plan)
    assert cuda_rnn.launch_counts() == before


@pytest.mark.cuda
def test_a_refused_launch_leaves_no_error_for_the_next_launch(cuda_device):
    """Once the card's own plan at (16,2048,512) has run, the plan of twice the SMs shares its threads and
    shared memory, so the residency check is behind it and the cooperative launch itself refuses. The
    error that call records must not come back from the cudaGetLastError() of the next launch, here of
    a cluster plan whose configuration was checked before the refusal."""
    spec = cuda_rnn.card_spec(cuda_device)
    lstm = _inputs("lstm", 2, 2048, 512, "float32", cuda_device)
    gru = _inputs("gru", 32, 512, 256, "bfloat16", cuda_device)
    with torch.no_grad():
        cuda_rnn._launch_lstm(*lstm)
        cuda_rnn._launch_gru(*gru)
        torch.cuda.synchronize()
        refused = cuda_rnn.grid_plan("lstm", 2048, 512, "float32", dataclasses.replace(spec, sms=2 * spec.sms))
        own = cuda_rnn.launch_plan("lstm", 2, 2048, 512, "float32", spec)
        assert (refused.threads, refused.smem) == (own.threads, own.smem) and refused.grid > spec.sms
        with pytest.raises(RuntimeError, match="CUDA error 720"):
            cuda_rnn._launch_lstm(*lstm, plan=refused)
        cuda_rnn.reset_launch_counts()
        out, _ = cuda_rnn._launch_gru(*gru)
        torch.cuda.synchronize()
    assert cuda_rnn.launch_counts()["gru_seq"] == 1 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_bench_grid_battle_runs_gru_seq_on_the_card(cuda_device):
    """bench_gpu.py's grid-battle scenario at its smoke depth: the row names the card and its power
    limit, its MFU is possible, and the learner launched `gru_seq` (cluster design) and its backward
    `gru_seq_cluster_bwd` twice an iteration (2 minibatches of 16384 samples), no other RNN kernel."""
    import bench_gpu

    device = torch.device("cuda", 0)
    b = bench_gpu.Bench(device, bench_gpu.SMOKE, bench_gpu.read_card(device))
    suite = []
    assert bench_gpu._try_scenario(suite, "grid_battle_pixel_rnn_ppo", bench_gpu.s_grid_battle, b), suite
    row = suite[0]
    assert row["device"] == torch.cuda.get_device_name(0) and row["power_limit_w"] > 0
    assert ("mfu" in row) == (bench_gpu._device_peak_bf16(row["device"]) is not None)
    assert row.get("mfu", 0.0) < 1 and "mfu_violation" not in row
    launches, iterations = row["rnn_kernel_launches"], row["iterations_counted"]
    assert iterations == b.depth.window + b.depth.profiled
    assert launches == {**dict.fromkeys(launches, 0), "gru_seq": 2 * iterations, "gru_seq_cluster_bwd": 2 * iterations}
    assert 0 < row["device_busy_ms_per_iteration"] and 0 <= row["device_idle_share_profiled"] < 1


# ------------------------------------------------------------------ the backward kernels (gru_seq_bwd, lstm_seq_bwd)

# the backward kernel against its plain version on the same inputs (the saved tensors, the prologue's
# projections and the cotangents), relative to the largest gradient: float32 differs only in the order of the
# products' sums; bf16 in that order and in the one-ulp flips it causes where an output is rounded to bf16
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _backward_pieces(kind):
    if kind == "gru":
        return cuda_rnn.gru_seq_backward, cuda_rnn.gru_seq_bwd_reference, cuda_rnn._launch_gru_bwd
    return cuda_rnn.lstm_seq_backward, cuda_rnn.lstm_seq_bwd_reference, cuda_rnn._launch_lstm_bwd


def _cotangents(out, state, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32), device=out.device),
            torch.tensor(rng.normal(size=tuple(state.shape)).astype(np.float32), device=out.device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("T,B,H", CARD_SHAPES + [(3, 5, 100), (2, 3, 1)])
def test_backward_kernel_matches_plain_on_card(cuda_device, kind, dtype, T, B, H):
    """The backward with the kernel as its recurrence against the same prologue and epilogue around the plain
    recurrence, from the kernel forward's outputs: one launch of the planned backward kernel (the grid design's in
    float32 where the forward takes the grid design, else the row design's), no other."""
    backward, plain, _ = _backward_pieces(kind)
    args = _inputs(kind, T, B, H, dtype, cuda_device, seed=9)
    planned = cuda_rnn._bwd_kernel_name(kind, cuda_rnn.bwd_plan(kind, B, H, dtype, cuda_rnn.card_spec(cuda_device)))
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        d_out, d_state = _cotangents(out, state)
        cuda_rnn.reset_launch_counts()
        got = backward(*args, out, d_out, d_state)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, planned: 1}
        want = backward(*args, out, d_out, d_state, recurrence=plain)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max())) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_backward_kernel_on_resets_and_saturated_gates(cuda_device, kind):
    """Rows reset at every step, and sigmoid gates whose pre-activations lie below -88: finite gradients, the
    saturated gates' exactly 0, equal to the plain recurrence's."""
    backward, plain, _ = _backward_pieces(kind)
    T, B, H = 8, 64, 256
    args = _masked_inputs(kind, T, B, H, "float32", cuda_device)
    sigmoid_gates = [0, 1] if kind == "gru" else [0, 1, 3]  # r, z / i, f, o
    for g in sigmoid_gates:
        args[0][:, :8, g * H:(g + 1) * H] = -200.0
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        got = backward(*args, out, *_cotangents(out, state))
        want = backward(*args, out, *_cotangents(out, state), recurrence=plain)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g in sigmoid_gates:
        assert bool((got[0][:, :8, g * H:(g + 1) * H] == 0).all()), f"gate {g} below -88 has a gradient"
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= BWD_TOL["float32"]


@pytest.mark.cuda
def test_an_impossible_backward_launch_raises(cuda_device):
    """8 rows a block at H=1024 in float32 need 384 KB of shared memory, above the card's limit, and no kernel is
    built for 3 rows: both launches are refused and raise, naming the rows and the card's SMs; nothing is counted."""
    T, B, H = 2, 16, 1024
    args = _inputs("lstm", T, B, H, "float32", cuda_device)
    d_out, d_state = torch.zeros(T, B, H, device=cuda_device), torch.zeros(B, 2 * H, device=cuda_device)
    before = cuda_rnn.launch_counts()
    for rows in (8, 3):
        with pytest.raises(RuntimeError, match=rf"lstm_seq_backward launch failed: CUDA error \d+ .*{rows} rows a block.*SMs"):
            cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], args[0], args[1], args[3], rows=rows)
    assert cuda_rnn.launch_counts() == before
    with torch.no_grad():  # and the next launch runs
        cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], args[0], args[1], args[3])
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_grid_battle_train_call_launches_the_backward_once_a_forward(cuda_device, tmp_path):
    """One sync train call of grid battle (convnet_impala, GRU-256, bf16; 64 envs x 32 steps in 2 minibatches of
    1024): `gru_seq_cluster_bwd` launches as often as `gru_seq`, once a minibatch, and no `gru_seq_bwd`; the rollout
    launches neither."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    argv = ["--env=grid_battle", "--use_rnn=True", "--rnn_type=gru", "--rnn_size=256", "--compute_dtype=bfloat16", "--rollout=32",
            "--recurrence=32", "--num_epochs=1", "--async_rl=False", "--encoder_conv_architecture=convnet_impala", "--num_envs=64",
            "--batch_size=1024", "--num_workers=1", f"--train_dir={tmp_path}", "--device=gpu", "--seed=0", "--experiment=bwd"]
    _, runner = make_rl_runner(parse_custom_args(argv))
    runner.init()
    ts = runner.train_state
    cuda_rnn.reset_launch_counts()
    runner.sampler_state, traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state, ts.train_step, runner.policy_id)
    torch.cuda.synchronize()
    assert not any(cuda_rnn.launch_counts().values())
    runner._train_fn(ts, traj, runner.train_generator)
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "gru_seq": 2, "gru_seq_cluster_bwd": 2}


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_backward_launch_passes_the_rows_and_shared_memory(monkeypatch, kind):
    """`_launch_bwd` asks card_spec for the device, packs wh^T, and passes T, B, H, the dtype flag, the rows of
    bwd_rows for that spec and their shared memory; it counts one launch. (At H=100 both kinds take the row design; at
    H=64 the LSTM takes the resident design since it came.)"""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["66-7-3"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 300, 100
    args = _inputs(kind, T, B, H, "float32", "cpu")
    d_out, d_state = torch.zeros(T, B, H), torch.zeros(args[1].shape)
    before = cuda_rnn.launch_counts()[f"{kind}_seq_bwd"]
    if kind == "gru":
        h_prev = torch.zeros(T, B, H)
        outputs = cuda_rnn._launch_gru_bwd(d_out, d_state, args[2], args[0], args[0].clone(), h_prev, args[3])
    else:
        outputs = cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], args[0], args[1], args[3])
    rows = cuda_rnn.bwd_rows(kind, B, H, "float32", spec)
    assert rows == 4 and -(-B // rows) >= spec.sms  # 300 // 66 = 4 rows: 75 blocks
    (name, call), = calls
    assert name == f"{kind}_seq_backward" and len(call) == (17 if kind == "gru" else 16)
    assert list(call[-7:-1]) == [T, B, H, 0, rows, cuda_rnn.bwd_smem(kind, H, rows, 4)]
    d_hn = [(T, B, H)] if kind == "gru" else []  # the GRU's n column of d_h_proj; its r and z columns are d_x_proj's
    assert [tuple(o.shape) for o in outputs] == [tuple(args[0].shape)] + d_hn + [tuple(args[1].shape)]
    assert cuda_rnn.launch_counts()[f"{kind}_seq_bwd"] == before + 1
    cuda_rnn._launches[f"{kind}_seq_bwd"] -= 1


def test_a_refused_backward_launch_names_the_shape_rows_and_sms(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    lib = cuda_rnn.load_library()
    lib.gru_seq_backward = lambda *args: 1  # cudaErrorInvalidValue
    lib.gru_seq_backward.__name__ = "gru_seq_backward"
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: SMALL_SPECS["114-13-0"])
    T, B, H = 2, 5, 32
    args = _inputs("gru", T, B, H, "float32", "cpu")
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"gru_seq_backward launch failed: CUDA error 1 \(T=2, B=5, H=32, torch.float32: 1 rows a block"
                                           r", 5 blocks, .* on a card of 114 SMs"):
        cuda_rnn._launch_gru_bwd(torch.zeros(T, B, H), torch.zeros(B, H), args[2], args[0], args[0], torch.zeros(T, B, H), args[3])
    assert cuda_rnn.launch_counts() == before


# ------------------------------------------------------------------ the backward's grid design (gru_seq_grid_bwd, lstm_seq_grid_bwd)

# the five float32 H=512 learner sites (Doom, `tp` (b), the defaults, NetHack, AllegroHandLSTM) and the shapes that keep
# the row design, where no cluster slice fits or the forward's cluster plan needs waves at a small width (the GRU: the
# LSTM takes the resident design there): bf16 at H=1024, H=100, and GRU-64 over 512, 1024 and 2048 segments
BWD_GRID_SITES = [("gru", 32, 64, 512), ("gru", 16, 4, 512), ("gru", 32, 32, 512), ("lstm", 32, 24, 512), ("lstm", 16, 2048, 512)]
BWD_ROW_SITES = [("lstm", 32, 512, 100, "float32"), ("gru", 16, 512, 64, "float32"), ("gru", 16, 1024, 64, "float32"),
                 ("gru", 16, 2048, 64, "bfloat16"), ("gru", 4, 16, 1024, "bfloat16"), ("lstm", 4, 16, 1024, "bfloat16"),
                 ("gru", 32, 512, 1024, "bfloat16"), ("gru", 3, 5, 100, "float32"), ("lstm", 3, 5, 100, "bfloat16"),
                 ("gru", 32, 512, 100, "bfloat16")]
# the grid backward's plan at each grid site on each card the planner is held to (Plan's fields): 4 x 4 accumulators a
# thread; at small B K split 16 or 32 ways (a cell a thread), slices of 16 units where they fill the SMs, 8 or 4 where the
# rows are too few; AllegroHandLSTM's 512 rows in chunks of 16 columns (688 and 1024 in 2 passes on the smaller cards)
BWD_GRID_PLANS = {
    "": [("grid", 32, 16, 16, 197120, 128, 4, 4, 32, 512, 1, 512), ("grid", 128, 4, 4, 43136, 128, 4, 4, 32, 512, 1, 32),
         ("grid", 32, 8, 16, 147712, 128, 4, 4, 32, 512, 1, 256), ("grid", 64, 12, 8, 127360, 128, 4, 4, 32, 512, 1, 192),
         ("grid", 32, 512, 16, 212992, 128, 4, 4, 1, 16, 1, 512)],
    "114-13-0": [("grid", 32, 24, 16, 221952, 96, 4, 4, 16, 512, 1, 384), ("grid", 64, 4, 8, 69760, 64, 4, 4, 32, 512, 1, 64),
                 ("grid", 32, 12, 16, 172416, 96, 4, 4, 32, 512, 1, 384), ("grid", 32, 8, 16, 180480, 96, 4, 4, 32, 512, 1, 256),
                 ("grid", 32, 688, 16, 230144, 96, 4, 4, 1, 32, 2, 344)],
    "66-7-3": [("grid", 32, 32, 16, 197632, 64, 4, 4, 16, 256, 1, 512), ("grid", 64, 4, 8, 69760, 64, 4, 4, 32, 512, 1, 64),
               ("grid", 32, 16, 16, 197120, 64, 4, 4, 32, 512, 1, 512), ("grid", 32, 12, 16, 205184, 64, 4, 4, 32, 512, 1, 384),
               ("grid", 32, 1024, 16, 212992, 64, 4, 4, 1, 16, 2, 512)],
}
BWD_SITE_IDS = ["-".join(map(str, site)) for site in BWD_GRID_SITES]


@pytest.mark.parametrize("kind,dtype,B,H,spec", PLAN_CASES)
def test_backward_plan_fits_the_card_and_covers_every_unit(kind, dtype, B, H, spec):
    """The backward takes the grid and the cluster designs exactly where the forward does; a grid plan keeps one block
    an SM at most, fits the card's shared memory, gives each (row, unit) pair to exactly one block, and its threads are
    the register tiles of a pass times the K splits, a cell a thread where K is split; a cluster plan takes the forward's
    cluster and unit slice (never a size the card runs none of), rows in steps of the product's granularity, and fits;
    elsewhere the row design at bwd_rows."""
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    forward = cuda_rnn.launch_plan(kind, 32, B, H, dtype, spec)
    assert (plan.design == "grid") == (forward.design == "grid")
    assert (plan.design == "cluster") == (forward.design == "cluster")
    assert (plan.design == "resident") == (forward.design == "resident")
    assert plan.smem <= spec.smem_limit
    if plan.design == "cluster":
        _check_cluster_backward_plan(kind, dtype, B, H, spec, plan)
        return
    if plan.design == "resident":
        assert plan == cuda_rnn.resident_plan(kind, B, H, dtype, spec, backward=True)
        _check_resident_plan(plan, B, H, dtype, spec, cuda_rnn.resident_bwd_smem)
        return
    if plan.design == "rows":
        rows = cuda_rnn.bwd_rows(kind, B, H, dtype, spec)
        assert plan == cuda_rnn.Plan("rows", 1, rows, H, cuda_rnn.bwd_smem(kind, H, rows, 2 if dtype == "bfloat16" else 4), -(-B // rows))
        return
    assert dtype == "float32" and plan == cuda_rnn.bwd_grid_plan(kind, B, H, dtype, spec)
    assert plan.grid <= spec.sms and plan.units * plan.cluster == H and (plan.tile_rows, plan.tile_cols) == (4, 4)
    assert plan.threads == cuda_rnn.bwd_grid_threads(plan.units, plan.rows, plan.ksplit, plan.passes)
    assert 1 <= plan.threads <= cuda_rnn.BWD_GRID_MAX_THREADS
    assert plan.smem == cuda_rnn.bwd_grid_smem(kind, H, plan.units, plan.rows, plan.ksplit, plan.kchunk, plan.passes)
    assert plan.rows % (plan.passes * 4) == 0 and H % plan.kchunk == 0 and plan.kchunk % (4 * plan.ksplit) == 0
    assert plan.ksplit == 1 or (plan.passes == 1 and plan.rows * plan.units <= plan.threads)  # a cell a thread
    owner = np.zeros((B, H), dtype=np.int64)
    for block in range(plan.grid):
        tile, rank = divmod(block, plan.cluster)
        owner[tile * plan.rows:(tile + 1) * plan.rows, rank * plan.units:(rank + 1) * plan.units] += 1
    assert (owner == 1).all(), "every (row, unit) pair belongs to exactly one block"


@pytest.mark.parametrize("kind,T,B,H", BWD_GRID_SITES, ids=BWD_SITE_IDS)
def test_grid_backward_is_planned_at_the_float32_h512_learner_sites(kind, T, B, H):
    """The five float32 H=512 learner sites take the grid backward, as their forwards take the grid design; the same
    shapes in bf16 take the cluster backward, as their forwards take the cluster design (clusters of 16)."""
    assert cuda_rnn.launch_plan(kind, T, B, H, "float32").design == "grid"
    assert cuda_rnn.bwd_plan(kind, B, H, "float32").design == "grid"
    assert cuda_rnn.launch_plan(kind, T, B, H, "bfloat16").design == "cluster"
    assert cuda_rnn.bwd_plan(kind, B, H, "bfloat16") == cuda_rnn.bwd_cluster_plan(kind, B, H, "bfloat16")


@pytest.mark.parametrize("kind,T,B,H,dtype", BWD_ROW_SITES, ids=["-".join(map(str, site)) for site in BWD_ROW_SITES])
def test_backward_keeps_the_row_design_at_the_bf16_and_narrow_sites(kind, T, B, H, dtype):
    """Where the forward takes the row design, so does the backward, with the rows of bwd_rows as before."""
    assert cuda_rnn.launch_plan(kind, T, B, H, dtype).design == "rows"
    assert cuda_rnn.bwd_grid_plan(kind, B, H, dtype) is None and cuda_rnn.bwd_cluster_plan(kind, B, H, dtype) is None
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype)
    assert plan.design == "rows" and plan.rows == cuda_rnn.bwd_rows(kind, B, H, dtype)
    assert plan == cuda_rnn.bwd_row_plan(kind, B, H, plan.rows, 2 if dtype == "bfloat16" else 4)


@pytest.mark.parametrize("name", list(BWD_GRID_PLANS))
@pytest.mark.parametrize("i", range(len(BWD_GRID_SITES)), ids=BWD_SITE_IDS)
def test_grid_backward_plans_of_each_card_are_pinned(i, name):
    kind, _, B, H = BWD_GRID_SITES[i]
    spec = SMALL_SPECS.get(name, cuda_rnn.H100_SXM)
    assert cuda_rnn.bwd_plan(kind, B, H, "float32", spec) == cuda_rnn.Plan(*BWD_GRID_PLANS[name][i])


def _bwd_args(kind, T, B, H):
    """CPU stand-ins of the backward kernel's inputs: (d_outs, d_final, resets, x_proj or proj, h_proj, h_prev or hc0, wh)."""
    args = _inputs(kind, T, B, H, "float32", "cpu")
    d_out, d_state = torch.zeros(T, B, H), torch.zeros(args[1].shape)
    if kind == "gru":
        return d_out, d_state, args[2], args[0], args[0].clone(), torch.zeros(T, B, H), args[3]
    return d_out, d_state, args[2], args[0], None, args[1], args[3]


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_backward_launch_passes_the_grid_plan(monkeypatch, kind):
    """At a grid site `_launch_bwd` launches `*_seq_grid_backward` with the grid plan of the tensor's card (here 114 SMs):
    wh as it is, T, B, H, the units, rows, K splits, K chunk, passes, threads and shared memory; it counts one
    `*_seq_grid_bwd` and no `*_seq_bwd`."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["114-13-0"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 64, 512
    d_out, d_state, resets, a, h_proj, s, wh = _bwd_args(kind, T, B, H)
    before = cuda_rnn.launch_counts()
    outputs = cuda_rnn._launch_bwd(kind, d_out, d_state, resets, a, h_proj, s, wh)
    plan = cuda_rnn.bwd_plan(kind, B, H, "float32", spec)
    assert plan.design == "grid" and plan != cuda_rnn.bwd_plan(kind, B, H, "float32")
    (name, call), = calls
    assert name == f"{kind}_seq_grid_backward" and len(call) == (21 if kind == "gru" else 20)
    assert call[6 if kind == "gru" else 5] == wh.data_ptr()  # wh as given: the blocks read its rows
    assert list(call[-11:-1]) == [T, B, H, plan.units, plan.rows, plan.ksplit, plan.kchunk, plan.passes, plan.threads, plan.smem]
    d_hn = [(T, B, H)] if kind == "gru" else []
    assert [tuple(o.shape) for o in outputs] == [tuple(a.shape)] + d_hn + [tuple(d_state.shape)]
    after = cuda_rnn.launch_counts()
    assert after[f"{kind}_seq_grid_bwd"] == before[f"{kind}_seq_grid_bwd"] + 1 and after[f"{kind}_seq_bwd"] == before[f"{kind}_seq_bwd"]
    cuda_rnn._launches[f"{kind}_seq_grid_bwd"] -= 1


def test_grid_backward_copies_an_input_at_an_odd_offset(monkeypatch):
    """The grid design reads its inputs in 16-byte pieces: x_proj as a view one float into a buffer reaches the kernel as
    a copy on 16 bytes, with the same values; the aligned inputs pass as they are."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    T, B, H = 2, 64, 512
    d_out, d_state, resets, a, h_proj, s, wh = _bwd_args("gru", T, B, H)
    odd = torch.empty(a.numel() + 1)[1:].view_as(a).copy_(a)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    cuda_rnn._launch_bwd("gru", d_out, d_state, resets, odd, h_proj, s, wh)
    (_, call), = calls
    assert call[3] % 16 == 0 and call[3] != odd.data_ptr() and call[:3] == (d_out.data_ptr(), d_state.data_ptr(), resets.data_ptr())
    cuda_rnn._launches["gru_seq_grid_bwd"] -= 1


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_rows_force_the_row_design_at_a_grid_site(monkeypatch, kind):
    """`rows=` launches the row design whatever the shape (phase `bwd` times it beside the grid design): wh^T, the rows
    and their shared memory to `*_seq_backward`, counted as `*_seq_bwd`."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    T, B, H = 2, 64, 512
    d_out, d_state, resets, a, h_proj, s, wh = _bwd_args(kind, T, B, H)
    before = cuda_rnn.launch_counts()[f"{kind}_seq_bwd"]
    cuda_rnn._launch_bwd(kind, d_out, d_state, resets, a, h_proj, s, wh, rows=1)
    (name, call), = calls
    assert name == f"{kind}_seq_backward" and list(call[-7:-1]) == [T, B, H, 0, 1, cuda_rnn.bwd_smem(kind, H, 1, 4)]
    assert cuda_rnn.launch_counts()[f"{kind}_seq_bwd"] == before + 1
    cuda_rnn._launches[f"{kind}_seq_bwd"] -= 1


def test_a_refused_grid_backward_launch_names_the_plan_and_the_sms(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    lib = cuda_rnn.load_library()
    lib.lstm_seq_grid_backward = lambda *args: 720  # cudaErrorCooperativeLaunchTooLarge
    lib.lstm_seq_grid_backward.__name__ = "lstm_seq_grid_backward"
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: SMALL_SPECS["66-7-3"])
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"lstm_seq_grid_backward launch failed: CUDA error 720 \(T=2, B=24, H=512, torch.float32: "
                                           r"plan Plan\(design='grid'.*: 2 batch tiles x 32 slices of 16 units, 384 threads, 205184 bytes"
                                           r" of shared memory, on a card of 66 SMs"):
        cuda_rnn._launch_bwd("lstm", *_bwd_args("lstm", 2, 24, 512))
    assert cuda_rnn.launch_counts() == before


def test_the_grid_backward_refuses_bf16(monkeypatch):
    _fake_cuda(monkeypatch, [])
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    d_out, d_state, resets, a, h_proj, s, wh = _bwd_args("gru", 2, 64, 512)
    plan = cuda_rnn.bwd_grid_plan("gru", 64, 512, "float32")
    with pytest.raises(ValueError, match="the grid backward takes float32"):
        cuda_rnn._launch_bwd("gru", d_out, d_state, resets, a.bfloat16(), h_proj.bfloat16(), s, wh.bfloat16(), plan=plan)


# the grid backward on the card: the float32 CARD_SHAPES it takes, the five sites, and ragged last batch tiles: 37 rows in
# tiles of 12 (K split), 130 in tiles of 36 and 1100 in tiles of 276 (no K split)
BWD_GRID_CARD_SHAPES = ([(kind, T, B, H) for kind in ("gru", "lstm") for T, B, H in CARD_SHAPES
                         if cuda_rnn.launch_plan(kind, T, B, H, "float32").design == "grid"]
                        + BWD_GRID_SITES + [("gru", 7, 37, 512), ("lstm", 3, 130, 512), ("lstm", 2, 1100, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H", BWD_GRID_CARD_SHAPES, ids=["-".join(map(str, s)) for s in BWD_GRID_CARD_SHAPES])
def test_grid_backward_matches_plain_on_card(cuda_device, kind, T, B, H):
    """The grid backward kernel against its plain recurrence on the same inputs, within BWD_TOL (float32: the order of the
    product's sums alone); one `*_seq_grid_bwd` launch, no other."""
    _, plain, launch = _backward_pieces(kind)
    plan = cuda_rnn.bwd_plan(kind, B, H, "float32", cuda_rnn.card_spec(cuda_device))
    assert plan.design == "grid"
    args = _inputs(kind, T, B, H, "float32", cuda_device, seed=13)
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        d_out, d_state = _cotangents(out, state)
        h_prev = cuda_rnn._carries_in(args[1], args[2], out)
        rec = ((d_out, d_state, args[2], args[0], h_prev @ args[3] + args[4], h_prev, args[3]) if kind == "gru"
               else (d_out, d_state, args[2], args[0] + h_prev @ args[3], args[1], args[3]))
        cuda_rnn.reset_launch_counts()
        got = launch(*rec)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, f"{kind}_seq_grid_bwd": 1}
        want = plain(*rec)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= BWD_TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_grid_backward_on_resets_and_saturated_gates(cuda_device, kind):
    """The grid design at Doom's and NetHack's width: rows reset at every step and sigmoid gates below -88 give finite
    gradients, the saturated gates' exactly 0, equal to the plain recurrence's."""
    backward, plain, _ = _backward_pieces(kind)
    T, B, H = 8, 64, 512
    args = _masked_inputs(kind, T, B, H, "float32", cuda_device)
    assert cuda_rnn.bwd_plan(kind, B, H, "float32", cuda_rnn.card_spec(cuda_device)).design == "grid"
    sigmoid_gates = [0, 1] if kind == "gru" else [0, 1, 3]
    for g in sigmoid_gates:
        args[0][:, :8, g * H:(g + 1) * H] = -200.0
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        cuda_rnn.reset_launch_counts()
        got = backward(*args, out, *_cotangents(out, state))
        assert cuda_rnn.launch_counts()[f"{kind}_seq_grid_bwd"] == 1
        want = backward(*args, out, *_cotangents(out, state), recurrence=plain)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g in sigmoid_gates:
        assert bool((got[0][:, :8, g * H:(g + 1) * H] == 0).all()), f"gate {g} below -88 has a gradient"
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= BWD_TOL["float32"]


@pytest.mark.cuda
def test_a_grid_backward_plan_the_card_cannot_hold_at_once_is_refused(cuda_device):
    """AllegroHandLSTM's grid backward planned for twice this card's SMs, at the shared memory of one block an SM, is refused
    before launch (cudaErrorCooperativeLaunchTooLarge), counts nothing, and the next launch runs (P6)."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.bwd_grid_plan("lstm", 2048, 512, "float32", dataclasses.replace(spec, sms=2 * spec.sms))
    assert plan.grid > spec.sms and cuda_rnn.grid_bwd_blocks_per_sm("lstm", plan) == 1
    T, B, H = 2, 2048, 512
    args = _inputs("lstm", T, B, H, "float32", cuda_device)
    d_out, d_state = torch.zeros(T, B, H, device=cuda_device), torch.zeros(B, 2 * H, device=cuda_device)
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"lstm_seq_grid_backward launch failed: CUDA error 720 .*SMs"):
        cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], args[0], args[1], args[3], plan=plan)
    assert cuda_rnn.launch_counts() == before
    with torch.no_grad():
        got = cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], args[0], args[1], args[3])
        torch.cuda.synchronize()
    assert cuda_rnn.launch_counts()["lstm_seq_grid_bwd"] == before["lstm_seq_grid_bwd"] + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H", BWD_GRID_SITES, ids=BWD_SITE_IDS)
def test_grid_backward_plans_are_resident_at_once(cuda_device, kind, T, B, H):
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.bwd_plan(kind, B, H, "float32", spec)
    assert plan.grid <= spec.sms and plan.grid <= cuda_rnn.grid_bwd_blocks_per_sm(kind, plan) * spec.sms


# ------------------------------------------------------------------ the backward's cluster design (gru_seq_cluster_bwd, lstm_seq_cluster_bwd)

# the learner sites whose forward takes the cluster design: `main`, `appo`, `population`, `dp` (a) at (32, 512, 256) bf16;
# `selfplay` (32, 512, 512) bf16 (clusters of 16); `host_rnn` (32, 256, 256) bf16; `dp_host` (32, B, 256) float32 at 128,
# 131, 37 and 255 segments; `dp2` and `tp` (a) at (32, 512, 256) float32; `lstm` and `towers` (32, 128, 256) float32;
# DMLab's core (32, 32, 256) float32
BWD_CLUSTER_SITES = [("gru", 32, 512, 256, "bfloat16"), ("gru", 32, 512, 512, "bfloat16"), ("gru", 32, 256, 256, "bfloat16"),
                     *[("gru", 32, B, 256, "float32") for B in (128, 131, 37, 255)], ("gru", 32, 512, 256, "float32"),
                     ("lstm", 32, 128, 256, "float32"), ("lstm", 32, 32, 256, "float32")]
BWD_CLUSTER_IDS = ["-".join(map(str, site)) for site in BWD_CLUSTER_SITES]
# their backward plans on each card the planner is held to (Plan's fields and the receive buffers): the forward's cluster and
# unit slice, the fewest rows that keep one wave where the forward's does, two receive buffers, or one where that leaves a
# cluster more rows (selfplay: 32 rather than 16; `main` on 66 SMs: 64 rather than 48); the selfplay site takes the row
# design where the card runs no cluster of 16 (as its forward does)
BWD_CLUSTER_PLANS = {
    "": [("cluster", 8, 48, 32, 206016, 88), ("cluster", 16, 32, 32, 203392, 256, 1), ("cluster", 8, 32, 32, 154240, 64),
         ("cluster", 8, 16, 32, 157248, 64), ("cluster", 8, 16, 32, 157248, 72), ("cluster", 8, 8, 32, 128544, 40),
         ("cluster", 8, 24, 32, 185952, 88), ("cluster", 8, 32, 32, 214656, 128), ("cluster", 8, 16, 32, 190528, 64),
         ("cluster", 8, 8, 32, 161824, 32)],
    "114-13-0": [("cluster", 8, 48, 32, 206016, 88), None, ("cluster", 8, 32, 32, 154240, 64),
                 ("cluster", 8, 16, 32, 157248, 64), ("cluster", 8, 16, 32, 157248, 72), ("cluster", 8, 8, 32, 128544, 40),
                 ("cluster", 8, 24, 32, 185952, 88), ("cluster", 8, 32, 32, 214656, 128), ("cluster", 8, 16, 32, 190528, 64),
                 ("cluster", 8, 8, 32, 161824, 32)],
    "66-7-3": [("cluster", 8, 64, 32, 192256, 64, 1), ("cluster", 16, 32, 32, 203392, 256, 1), ("cluster", 8, 48, 32, 206016, 48),
               ("cluster", 8, 24, 32, 185952, 48), ("cluster", 8, 24, 32, 185952, 48), ("cluster", 8, 8, 32, 128544, 40),
               ("cluster", 8, 32, 32, 214656, 64), ("cluster", 8, 32, 32, 214656, 128), ("cluster", 8, 24, 32, 219232, 48),
               ("cluster", 8, 8, 32, 161824, 32)],
}


def _cluster_plan_fields(fields):
    if fields is None:
        return None
    *plan, buffers = fields if len(fields) == 7 else (*fields, 2)
    return cuda_rnn.Plan(*plan, buffers=buffers)


def _check_cluster_backward_plan(kind, dtype, B, H, spec, plan):
    """A cluster backward plan: the forward's cluster and unit slice (a size the card runs), rows in steps of the
    product's granularity, the fewest that keep one wave unless the cap or the block's shared memory holds them lower,
    two receive buffers unless one leaves more rows, its shared memory within the card's limit by the kernel's formula, and
    each (row, unit) pair in one block."""
    forward = cuda_rnn.launch_plan(kind, 32, B, H, dtype, spec)
    itemsize, step, cap = (2, 16, 64) if dtype == "bfloat16" else (4, 8, 32)
    assert plan == cuda_rnn.bwd_cluster_plan(kind, B, H, dtype, spec) and plan.design == "cluster"
    assert (plan.cluster, plan.units) == (forward.cluster, forward.units) and spec.clusters_at_once(plan.cluster) >= 1
    two, one = (cuda_rnn.bwd_cluster_plan(kind, B, H, dtype, spec, buffers=n) for n in (2, 1))
    assert plan == (one if two is None or one.rows > two.rows else two)
    assert plan.smem == cuda_rnn.bwd_cluster_smem(kind, H, plan.cluster, plan.rows, itemsize, plan.buffers)
    assert plan.smem <= spec.smem_limit and plan.rows % step == 0 and plan.grid == -(-B // plan.rows) * plan.cluster
    one_wave = plan.grid // plan.cluster <= spec.clusters_at_once(plan.cluster)
    assert one_wave or plan.rows == cap or \
        cuda_rnn.bwd_cluster_smem(kind, H, plan.cluster, plan.rows + step, itemsize, plan.buffers) > spec.smem_limit
    assert not one_wave or plan.rows == step or -(-B // (plan.rows - step)) > spec.clusters_at_once(plan.cluster)  # no fewer do
    owner = np.zeros((B, H), dtype=np.int64)
    for block in range(plan.grid):
        tile, rank = divmod(block, plan.cluster)
        owner[tile * plan.rows:(tile + 1) * plan.rows, rank * plan.units:(rank + 1) * plan.units] += 1
    assert (owner == 1).all(), "every (row, unit) pair belongs to exactly one block"


@pytest.mark.parametrize("name", list(BWD_CLUSTER_PLANS))
@pytest.mark.parametrize("i", range(len(BWD_CLUSTER_SITES)), ids=BWD_CLUSTER_IDS)
def test_cluster_backward_takes_the_forwards_cluster_and_units(i, name):
    """At every cluster site, on the H100 SXM and on the smaller cards, the backward takes the cluster design with the
    forward's cluster and unit slice, pinned; where the card runs no cluster of 16 (selfplay's forward takes the row
    design there) it keeps the row design."""
    kind, T, B, H, dtype = BWD_CLUSTER_SITES[i]
    spec = SMALL_SPECS.get(name, cuda_rnn.H100_SXM)
    want = _cluster_plan_fields(BWD_CLUSTER_PLANS[name][i])
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    if want is None:
        assert cuda_rnn.launch_plan(kind, T, B, H, dtype, spec).design == "rows" and plan.design == "rows"
        assert cuda_rnn.bwd_cluster_plan(kind, B, H, dtype, spec) is None
        return
    assert plan == want
    _check_cluster_backward_plan(kind, dtype, B, H, spec, plan)


def _bwd_cluster_cxx():
    """A host program of the kernel's shared-memory formula, csrc/rnn_seq.cu's own text, for g++."""
    source = cuda_rnn.SOURCE.read_text()
    parts = [re.search(r"__host__ __device__ constexpr size_t align16\(size_t n\) \{[^}]*\}", source).group(0),
             re.search(r"__host__ __device__ constexpr int bwd_cluster_k\(int GU, int elem\) \{[^}]*\}", source).group(0),
             re.search(r"inline size_t bwd_cluster_smem_bytes\(.*?\n\}", source, re.S).group(0)]
    program = ("#include <cstddef>\n#include <cstdio>\n#include <cstdlib>\n#define __host__\n#define __device__\n" + "\n".join(parts)
               + "\nint main(int argc, char** argv) { for (int i = 1; i + 5 < argc; i += 6) std::printf(\"%zu\\n\", "
                 "bwd_cluster_smem_bytes(atoi(argv[i]), atoi(argv[i + 1]), atoi(argv[i + 2]), atoi(argv[i + 3]), atoi(argv[i + 4]), "
                 "atoi(argv[i + 5]))); return 0; }\n")
    return program


def test_bwd_cluster_smem_is_the_kernels_formula(tmp_path):
    """bwd_cluster_smem in Python equals bwd_cluster_smem_bytes, the C++ launcher's check, at every width, cluster, row
    count, dtype, kind and buffer count the planner can reach (the C++ function compiled for the host from the source)."""
    if not shutil.which("g++"):
        pytest.skip("needs g++ to compile the kernel source's formula for the host")
    (tmp_path / "smem.cpp").write_text(_bwd_cluster_cxx())
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(tmp_path / "smem"), str(tmp_path / "smem.cpp")], check=True)
    cases = [(G, H, C, rows, elem, buffers) for G in (3, 4) for H in (64, 128, 256, 512, 1024) for C in (8, 16) if H // C >= 8
             for elem in (2, 4) for rows in range(16 if elem == 2 else 8, 65, 16 if elem == 2 else 8) for buffers in (1, 2)]
    out = subprocess.run([str(tmp_path / "smem"), *[str(v) for case in cases for v in case]], capture_output=True, text=True,
                         check=True).stdout.split()
    assert len(out) == len(cases)
    for (G, H, C, rows, elem, buffers), got in zip(cases, out):
        assert int(got) == cuda_rnn.bwd_cluster_smem({3: "gru", 4: "lstm"}[G], H, C, rows, elem, buffers), (G, H, C, rows, elem, buffers)


# the kernel's fragment maps, emulated in float64 on one cluster's rows: ldmatrix gives lane t of matrix m the elements
# (row t // 4, columns 2 (t % 4), +1), ldmatrix.trans (row 2 (t % 4), +1, column t // 4); mma.m16n8k16's A fragment a[0..3]
# is rows g, g + 8 of columns 2q.., then of 2q + 8.., its B fragment (k 2q.., n g), (k 2q + 8.., n g), its sums (row g,
# columns 2q, 2q + 1), (row g + 8, the same): lane t = 4g + q
_LANES = np.arange(32)
_G, _Q = _LANES // 4, _LANES % 4


def _ldmatrix(mem, flat, stride, trans):
    rows, cols = np.divmod(np.asarray(flat), stride)
    m = mem[rows[:, None], cols[:, None] + np.arange(8)].reshape(4, 8, 8)  # [matrix][row][column]
    e = np.arange(2)
    if trans:
        return m[:, 2 * _Q[:, None] + e, _G[:, None]].transpose(1, 0, 2)
    return m[:, _G[:, None], 2 * _Q[:, None] + e].transpose(1, 0, 2)


def _mma(a, b0, b1):
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for e in range(2):
        A[_G, 2 * _Q + e], A[_G + 8, 2 * _Q + e] = a[:, 0, e], a[:, 1, e]
        A[_G, 2 * _Q + 8 + e], A[_G + 8, 2 * _Q + 8 + e] = a[:, 2, e], a[:, 3, e]
        Bm[2 * _Q + e, _G], Bm[2 * _Q + 8 + e, _G] = b0[:, e], b1[:, e]
    return A @ Bm


def _emulate_mma_push(dgh, dgl, w, slots, r, BT, H, K, U):
    """bwd_mma_push of block r (csrc/rnn_seq.cu): dgh, dgl [BT][K + 8], w [K][H + 8] as the kernel lays them out in shared
    memory; slots [C][C][BT][U] (receiving block, sending block) of NaN, each element written once."""
    DS, HS, lu = K + 8, H + 8, U.bit_length() - 1
    nj = 4 if (BT // 16) * (H // 32) % 16 == 0 else 2
    groups, odd = H // (8 * nj), (_Q & 1).astype(bool)
    for item in range(BT // 16 * groups):
        m0, n0 = item // groups * 16, item % groups * 8 * nj
        a_at = (m0 + (_LANES & 7) + (_LANES >> 3 & 1) * 8) * DS + (_LANES >> 4) * 8
        pb = ((_LANES & 7) + (_LANES >> 3 & 1) * 8) * HS + n0 + (_LANES >> 4) * 8
        acc = np.zeros((nj, 16, 8))
        for k in range(0, K, 16):
            ah, al = _ldmatrix(dgh, a_at + k, DS, False), _ldmatrix(dgl, a_at + k, DS, False)
            b = {}
            for j in range(0, nj, 2):
                regs = _ldmatrix(w, pb + k * HS + j * 8, HS, True)
                b[j], b[j + 1] = (regs[:, 0], regs[:, 1]), (regs[:, 2], regs[:, 3])
            for j in range(nj):
                acc[j] += _mma(ah, *b[j]) + _mma(al, *b[j])
        for j in range(nj):
            d = np.stack([acc[j][_G, 2 * _Q], acc[j][_G, 2 * _Q + 1], acc[j][_G + 8, 2 * _Q], acc[j][_G + 8, 2 * _Q + 1]], axis=1)
            x0, x1 = np.where(odd, d[:, 0], d[:, 2]), np.where(odd, d[:, 1], d[:, 3])
            y0, y1 = x0[_LANES ^ 1], x1[_LANES ^ 1]
            v = np.where(odd[:, None], np.stack([y0, y1, d[:, 2], d[:, 3]], 1), np.stack([d[:, 0], d[:, 1], y0, y1], 1))
            row, col = m0 + _G + np.where(odd, 8, 0), n0 + j * 8 + 2 * (_Q & 2)
            for t in range(32):
                peer, u = col[t] >> lu, col[t] & (U - 1)
                assert np.isnan(slots[peer, r, row[t], u:u + 4]).all(), "a slot element written twice"
                slots[peer, r, row[t], u:u + 4] = v[t]


def _emulate_fma_push(dg, w, slots, r, BT, H, K, U):
    """bwd_fma_push of block r: dg [BT][K], w [K][H + 4]; RB rows x 4 columns a thread, as the kernel picks RB."""
    lu, cols = U.bit_length() - 1, H // 4
    rb = 8 if cols * (BT // 8) >= 256 else 4
    for it in range(cols * (BT // rb)):
        c, r0 = it % cols * 4, it // cols * rb
        s = dg[r0:r0 + rb, :K] @ w[:K, c:c + 4]
        for i in range(rb):
            peer, u = c >> lu, c & (U - 1)
            assert np.isnan(slots[peer, r, r0 + i, u:u + 4]).all(), "a slot element written twice"
            slots[peer, r, r0 + i, u:u + 4] = s[i]


# the cluster sites' (cluster, units, rows) and the small widths the cluster design also takes (a K that the mma's k16
# does not divide at the GRU-64's 8 units: 24 gate columns, padded to 32; the LSTM-64 takes the resident design)
BWD_EMULATED = BWD_CLUSTER_SITES + [("gru", 7, 24, 128, "bfloat16"), ("lstm", 7, 24, 128, "bfloat16"), ("gru", 5, 3, 64, "bfloat16"),
                                    ("lstm", 5, 3, 128, "float32"), ("lstm", 32, 512, 256, "bfloat16")]


@pytest.mark.parametrize("kind,T,B,H,dtype", BWD_EMULATED, ids=["-".join(map(str, s)) for s in BWD_EMULATED])
def test_cluster_backward_product_emulated_in_float64(kind, T, B, H, dtype):
    """The cluster backward's product as the kernel computes it, lane by lane in float64 on one cluster's rows: block r's
    rows of pack_wh (zero rows up to K) against its units' gate cotangents (bf16: a high and a low part), each column sent
    into its owner's slot r, each slot element written once; the slots summed in block order equal dg @ wh^T (bf16: to the
    2^-16 of the two-part split; float32: to rounding)."""
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype)
    assert plan.design == "cluster"
    C, U, BT, G = plan.cluster, plan.units, plan.rows, 3 if kind == "gru" else 4
    itemsize = 2 if dtype == "bfloat16" else 4
    K = cuda_rnn.bwd_cluster_k(kind, U, itemsize)
    rng = np.random.default_rng(B + H)
    wh = torch.tensor(rng.normal(size=(H, G * H)) / math.sqrt(H), dtype=torch.float32).to(getattr(torch, dtype))
    dg = rng.normal(size=(BT, G * H)).astype(np.float32)
    packed = cuda_rnn.pack_wh(wh, plan).double().numpy()
    slots = np.full((C, C, BT, U), np.nan)
    for r in range(C):
        cols = [g * H + r * U + u for g in range(G) for u in range(U)]
        w = np.zeros((K, H + 16 // itemsize))
        w[:G * U, :H] = packed[r]
        if dtype == "bfloat16":
            hi = torch.tensor(dg[:, cols]).bfloat16()
            lo = (torch.tensor(dg[:, cols]) - hi.float()).bfloat16()
            dgh, dgl = np.zeros((BT, K + 8)), np.zeros((BT, K + 8))
            dgh[:, :G * U], dgl[:, :G * U] = hi.double().numpy(), lo.double().numpy()
            _emulate_mma_push(dgh, dgl, w, slots, r, BT, H, K, U)
        else:
            dgr = np.zeros((BT, K))
            dgr[:, :G * U] = dg[:, cols]
            _emulate_fma_push(dgr, w, slots, r, BT, H, K, U)
    assert not np.isnan(slots).any(), "every slot element is written"
    got = np.concatenate([sum(slots[q, r] for r in range(C)) for q in range(C)], axis=1)  # block q's units, in block order
    want = dg.astype(np.float64) @ wh.double().numpy().T
    tol = 1e-4 if dtype == "bfloat16" else 1e-12
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _cluster_bwd_args(kind, T, B, H, dtype="float32"):
    d_out, d_state, resets, a, h_proj, s, wh = _bwd_args(kind, T, B, H)
    dt = getattr(torch, dtype)
    return d_out, d_state, resets, a.to(dt), None if h_proj is None else h_proj.to(dt), s, wh.to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_backward_launch_passes_the_cluster_plan(monkeypatch, kind, dtype):
    """At a cluster site `_launch_bwd` launches `*_seq_cluster_backward` with the cluster plan of the tensor's card (here 66
    SMs): T, B, H, the dtype flag, the cluster, rows, receive buffers and shared memory (bwd_cluster_smem's bytes, which the
    launcher checks against its own formula); it counts one `*_seq_cluster_bwd` and no other backward."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["66-7-3"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 128, 256
    args = _cluster_bwd_args(kind, T, B, H, dtype)
    before = cuda_rnn.launch_counts()
    outputs = cuda_rnn._launch_bwd(kind, *args)
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    assert plan.design == "cluster" and plan != cuda_rnn.bwd_plan(kind, B, H, dtype)
    (name, call), = calls
    assert name == f"{kind}_seq_cluster_backward" and len(call) == (19 if kind == "gru" else 18)
    itemsize = 2 if dtype == "bfloat16" else 4
    assert list(call[-9:-1]) == [T, B, H, int(dtype == "bfloat16"), plan.cluster, plan.rows, plan.buffers, plan.smem]
    assert plan.smem == cuda_rnn.bwd_cluster_smem(kind, H, plan.cluster, plan.rows, itemsize, plan.buffers)
    d_hn = [(T, B, H)] if kind == "gru" else []
    assert [tuple(o.shape) for o in outputs] == [tuple(args[3].shape)] + d_hn + [tuple(args[1].shape)]
    assert outputs[0].dtype == args[3].dtype
    after = cuda_rnn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), f"{kind}_seq_cluster_bwd": 1}
    cuda_rnn._launches[f"{kind}_seq_cluster_bwd"] -= 1


def test_cluster_backward_copies_an_input_at_an_odd_offset(monkeypatch):
    """The cluster design copies its inputs in 16-byte pieces: x_proj as a view one element into a buffer reaches the kernel
    as a copy on 16 bytes; the aligned inputs pass as they are."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    d_out, d_state, resets, a, h_proj, s, wh = _cluster_bwd_args("gru", 2, 64, 256, "bfloat16")
    odd = torch.empty(a.numel() + 1, dtype=a.dtype)[1:].view_as(a).copy_(a)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    cuda_rnn._launch_bwd("gru", d_out, d_state, resets, odd, h_proj, s, wh)
    (name, call), = calls
    assert name == "gru_seq_cluster_backward" and call[3] % 16 == 0 and call[3] != odd.data_ptr()
    assert call[:3] == (d_out.data_ptr(), d_state.data_ptr(), resets.data_ptr()) and call[4] == h_proj.data_ptr()
    cuda_rnn._launches["gru_seq_cluster_bwd"] -= 1


def test_a_refused_cluster_backward_launch_names_the_plan_and_the_sms(monkeypatch):
    """A cluster backward launch that the card refuses (cudaErrorInvalidConfiguration: no cluster of the plan fits) raises,
    naming the shape, the plan, its clusters and rows, its shared memory and the card's SMs; nothing is counted and no other
    design runs."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    lib = cuda_rnn.load_library()
    lib.lstm_seq_cluster_backward = lambda *args: 9  # cudaErrorInvalidConfiguration
    lib.lstm_seq_cluster_backward.__name__ = "lstm_seq_cluster_backward"
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: SMALL_SPECS["114-13-0"])
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"lstm_seq_cluster_backward launch failed: CUDA error 9 \(T=2, B=128, H=256, torch.float32: "
                                           r"plan Plan\(design='cluster'.*: 8 clusters of 8 blocks, 16 rows and 32 units a block, 2 "
                                           r"receive buffers, 190528 bytes of shared memory, on a card of 114 SMs"):
        cuda_rnn._launch_bwd("lstm", *_cluster_bwd_args("lstm", 2, 128, 256))
    assert cuda_rnn.launch_counts() == before and calls == []


# the cluster backward on the card: every cluster site, the small widths of CARD_SHAPES in both dtypes where the cluster design
# takes them (the GRU-64's K padded to the mma's k16; the LSTM-64 takes the resident design), and ragged last clusters
# (dp_host's 37, 131 and 255 segments are among the sites)
BWD_CLUSTER_CARD_SHAPES = BWD_CLUSTER_SITES + [(kind, T, B, H, dtype) for kind in ("gru", "lstm") for dtype in ("float32", "bfloat16")
                                               for T, B, H in [(7, 24, 128), (1, 8, 128), (5, 3, 64), (3, 45, 256)]
                                               if cuda_rnn.bwd_plan(kind, B, H, dtype).design == "cluster"]


def _recurrence_inputs(kind, T, B, H, dtype, device, seed=13, masked=False):
    """The kernel forward's outputs and the backward recurrence's inputs as the prologue makes them."""
    args = (_masked_inputs if masked else _inputs)(kind, T, B, H, dtype, device, seed=seed)
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        d_out, d_state = _cotangents(out, state)
        h_prev = cuda_rnn._carries_in(args[1], args[2], out)
        h_in = h_prev.to(args[0].dtype)
    if kind == "gru":
        return args, (d_out, d_state, args[2], args[0], h_in @ args[3] + args[4], h_prev, args[3])
    return args, (d_out, d_state, args[2], args[0] + h_in @ args[3], args[1], args[3])


def _bwd_rel_err(got, want):
    return max(float((g.float() - w.float()).abs().max()) / max(1.0, float(w.float().abs().max())) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype", BWD_CLUSTER_CARD_SHAPES, ids=["-".join(map(str, s)) for s in BWD_CLUSTER_CARD_SHAPES])
def test_cluster_backward_matches_plain_on_card(cuda_device, kind, T, B, H, dtype):
    """The cluster backward kernel against its plain recurrence on the same inputs, within BWD_TOL; one
    `*_seq_cluster_bwd` launch, no other."""
    _, plain, launch = _backward_pieces(kind)
    assert cuda_rnn.bwd_plan(kind, B, H, dtype, cuda_rnn.card_spec(cuda_device)).design == "cluster"
    _, rec = _recurrence_inputs(kind, T, B, H, dtype, cuda_device)
    with torch.no_grad():
        cuda_rnn.reset_launch_counts()
        got = launch(*rec)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, f"{kind}_seq_cluster_bwd": 1}
        want = plain(*rec)
    assert all(g.dtype == w.dtype and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype", [("gru", 32, 512, 512, "bfloat16"), ("gru", 32, 512, 256, "bfloat16"),
                                             ("lstm", 32, 128, 256, "float32"), ("gru", 32, 37, 256, "float32")])
def test_cluster_backward_with_the_other_receive_buffer_count_matches_plain_on_card(cuda_device, kind, T, B, H, dtype):
    """The plan at the receive-buffer count the site's plan does not take (one buffer: a second cluster barrier a step,
    before the product; two: the slots alternate), at the rows it allows, against the plain recurrence."""
    _, plain, launch = _backward_pieces(kind)
    spec = cuda_rnn.card_spec(cuda_device)
    planned = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    plan = cuda_rnn.bwd_cluster_plan(kind, B, H, dtype, spec, buffers=3 - planned.buffers)
    assert plan.buffers != planned.buffers
    _, rec = _recurrence_inputs(kind, T, B, H, dtype, cuda_device, seed=14)
    with torch.no_grad():
        got = launch(*rec, plan=plan)
        torch.cuda.synchronize()
        want = plain(*rec)
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cluster_backward_on_resets_and_saturated_gates(cuda_device, kind, dtype):
    """The cluster design at the main width: every second row reset at every step, and sigmoid gates whose pre-activations
    lie below -88: finite gradients, the saturated gates' exactly 0, equal to the plain recurrence's."""
    backward, plain, _ = _backward_pieces(kind)
    T, B, H = 8, 64, 256
    args = _masked_inputs(kind, T, B, H, dtype, cuda_device)
    assert cuda_rnn.bwd_plan(kind, B, H, dtype, cuda_rnn.card_spec(cuda_device)).design == "cluster"
    sigmoid_gates = [0, 1] if kind == "gru" else [0, 1, 3]
    for g in sigmoid_gates:
        args[0][:, :8, g * H:(g + 1) * H] = -200.0
    with torch.no_grad():
        out, state = _fns(kind)[0](*args)
        cuda_rnn.reset_launch_counts()
        got = backward(*args, out, *_cotangents(out, state))
        assert cuda_rnn.launch_counts()[f"{kind}_seq_cluster_bwd"] == 1
        want = backward(*args, out, *_cotangents(out, state), recurrence=plain)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g in sigmoid_gates:
        assert bool((got[0][:, :8, g * H:(g + 1) * H] == 0).all()), f"gate {g} below -88 has a gradient"
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_a_cluster_backward_plan_the_card_cannot_hold_is_refused(cuda_device):
    """The selfplay site's cluster backward at 64 rows a cluster needs more shared memory than a block may take: the launch
    is refused and raises, naming the plan and the card's SMs; nothing is counted, and the next launch runs (P6)."""
    spec = cuda_rnn.card_spec(cuda_device)
    kind, T, B, H, dtype = "gru", 4, 512, 512, "bfloat16"
    good = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    smem = cuda_rnn.bwd_cluster_smem(kind, H, 16, 64, 2, good.buffers)
    assert smem > spec.smem_limit
    refused = dataclasses.replace(good, rows=64, smem=smem, grid=B // 64 * 16)
    _, rec = _recurrence_inputs(kind, T, B, H, dtype, cuda_device)
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"gru_seq_cluster_backward launch failed: CUDA error \d+ .*64 rows.*SMs"):
        cuda_rnn._launch_gru_bwd(*rec, plan=refused)
    assert cuda_rnn.launch_counts() == before
    with torch.no_grad():
        got = cuda_rnn._launch_gru_bwd(*rec)
        torch.cuda.synchronize()
        want = cuda_rnn.gru_seq_bwd_reference(*rec)
    assert cuda_rnn.launch_counts()["gru_seq_cluster_bwd"] == before["gru_seq_cluster_bwd"] + 1
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL_SPECS))
@pytest.mark.parametrize("i", range(len(BWD_CLUSTER_SITES)), ids=BWD_CLUSTER_IDS)
def test_smaller_cards_cluster_backward_plans_match_plain_on_card(cuda_device, i, name):
    """The backward plans made for 114 and 66 SMs at every cluster site, launched on this card, against the plain
    recurrence."""
    kind, T, B, H, dtype = BWD_CLUSTER_SITES[i]
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, SMALL_SPECS[name])
    if plan.design != "cluster":
        pytest.skip(f"the {name} card's backward at {BWD_CLUSTER_SITES[i]} is the row design, held by the backward tests")
    _, plain, launch = _backward_pieces(kind)
    _, rec = _recurrence_inputs(kind, T, B, H, dtype, cuda_device, seed=15)
    with torch.no_grad():
        got = launch(*rec, plan=plan)
        torch.cuda.synchronize()
        want = plain(*rec)
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,dtype", BWD_CLUSTER_SITES, ids=BWD_CLUSTER_IDS)
def test_cluster_backward_plans_run_on_the_card(cuda_device, kind, T, B, H, dtype):
    """Every cluster site's backward plan has clusters that the card runs (cudaOccupancyMaxActiveClusters at the plan's
    shared memory), and as many at once as the forward's spec counts at one block an SM."""
    spec = cuda_rnn.card_spec(cuda_device)
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, spec)
    assert plan.design == "cluster"
    assert cuda_rnn.max_active_bwd_clusters(kind, dtype, plan) >= max(1, spec.clusters_at_once(plan.cluster))


# ------------------------------------------------------------------ the LSTM's resident design (lstm_seq_resident, lstm_seq_resident_bwd)

# DMLab's instruction encoder: a rollout slot's (16, 64, 64), the last-value pass's (16, 128, 64) and a learner minibatch's
# (16, 1024, 64) in float32, and (16, 2048, 64) in bf16 (the learner's batch at twice the rows)
RESIDENT_SITES = [(16, 64, 64, "float32"), (16, 128, 64, "float32"), (16, 1024, 64, "float32"), (16, 2048, 64, "bfloat16")]
RESIDENT_SPECS = {"": cuda_rnn.H100_SXM, **SMALL_SPECS}


@pytest.mark.parametrize("name", list(RESIDENT_SPECS))
@pytest.mark.parametrize("T,B,H,dtype", RESIDENT_SITES, ids=["-".join(map(str, s)) for s in RESIDENT_SITES])
def test_resident_plans_at_the_dmlab_sites(T, B, H, dtype, name):
    """At DMLab's instruction-encoder sites, on the H100 SXM and on the smaller cards (132, 114 and 66 SMs): the resident
    plan's rows cover B, its blocks fill the SMs in one wave, its threads are 4 warps at least where the rows allow, and its
    shared memory (the forward's and the backward's) is the kernel's formula within the card's limit; the learner minibatch's
    takes the resident design forward and backward (its cluster plan needs several waves on every card here), and so does
    every site here (the rollout's and the last value's over a cluster plan of one wave)."""
    spec = RESIDENT_SPECS[name]
    fwd, bwd = cuda_rnn.resident_plan("lstm", B, H, dtype, spec), cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True)
    _check_resident_plan(fwd, B, H, dtype, spec, cuda_rnn.resident_smem)
    _check_resident_plan(bwd, B, H, dtype, spec, cuda_rnn.resident_bwd_smem)
    assert fwd.rows * fwd.grid >= B and fwd.grid <= spec.sms and (fwd.rows, fwd.grid) == (bwd.rows, bwd.grid)
    if B >= 1024:
        assert cuda_rnn.cluster_waves(cuda_rnn.cluster_plan("lstm", B, H, dtype, spec), spec) > 1
    assert cuda_rnn.launch_plan("lstm", T, B, H, dtype, spec) == fwd and cuda_rnn.bwd_plan("lstm", B, H, dtype, spec) == bwd
    if name == "":
        assert (fwd.rows, fwd.grid, fwd.tile_rows, fwd.threads) == {64: (1, 64, 1, 64), 128: (1, 128, 1, 64), 1024: (8, 128, 4, 128),
                                                                     2048: (16, 128, 4, 256)}[B]


def test_the_resident_design_takes_the_lstm_alone():
    """The GRU has no resident kernel: no resident plan, and its small widths keep the row design over waves."""
    assert cuda_rnn.resident_plan("gru", 1024, 64, "float32") is None
    assert cuda_rnn.launch_plan("gru", 16, 1024, 64, "float32").design == "rows"
    assert cuda_rnn.bwd_plan("gru", 1024, 64, "float32").design == "rows"
    assert cuda_rnn.resident_plan("lstm", 1024, 60, "float32") is None  # H a multiple of 8: the forward product's chunks of k


def _resident_cxx():
    """A host program of the resident kernels' rule and formulas, csrc/rnn_seq.cu's own text, for g++."""
    source = cuda_rnn.SOURCE.read_text()
    parts = [re.search(r"__host__ __device__ constexpr size_t align16\(size_t n\) \{[^}]*\}", source).group(0),
             re.search(r"constexpr int kResidentMinThreads = \d+;", source).group(0),
             re.search(r"__host__ __device__ constexpr int resident_rows_a_thread\(int R, int H\) \{.*?\n\}", source, re.S).group(0),
             re.search(r"inline size_t resident_smem_bytes\(.*?\n\}", source, re.S).group(0),
             re.search(r"inline size_t resident_bwd_smem_bytes\(.*?\n\}", source, re.S).group(0)]
    return ("#include <cstddef>\n#include <cstdio>\n#include <cstdlib>\n#define __host__\n#define __device__\n" + "\n".join(parts)
            + "\nint main(int argc, char** argv) { for (int i = 1; i + 1 < argc; i += 2) { int H = atoi(argv[i]), R = atoi(argv[i + 1]); "
              "std::printf(\"%d %zu %zu\\n\", resident_rows_a_thread(R, H), resident_smem_bytes(H, R), resident_bwd_smem_bytes(H, R)); } "
              "return 0; }\n")


def test_resident_rule_and_smem_are_the_kernels(tmp_path):
    """resident_rows_a_thread, resident_smem and resident_bwd_smem in Python equal the kernel source's own (compiled for the
    host with g++), at every width and row count the planner can reach here."""
    if not shutil.which("g++"):
        pytest.skip("needs g++ to compile the kernel source's formulas for the host")
    (tmp_path / "resident.cpp").write_text(_resident_cxx())
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(tmp_path / "resident"), str(tmp_path / "resident.cpp")], check=True)
    cases = [(H, R) for H in (8, 16, 32, 48, 64, 96) for R in (1, 2, 3, 4, 6, 8, 16, 32, 64)]
    out = subprocess.run([str(tmp_path / "resident"), *[str(v) for case in cases for v in case]], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert len(out) == len(cases)
    for (H, R), line in zip(cases, out):
        want = [cuda_rnn.resident_rows_a_thread(R, H), cuda_rnn.resident_smem(H, R), cuda_rnn.resident_bwd_smem(H, R)]
        assert [int(v) for v in line.split()] == want, (H, R)


def _float_at(ptr, n):
    """n float32 values at a host address (a CPU tensor's data_ptr), copied out."""
    import ctypes

    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_launch_passes_the_plan(monkeypatch, dtype):
    """At DMLab's learner shape `_launch` launches `lstm_resident_forward` with the resident plan of the tensor's card (here
    114 SMs): x_proj, hc0, resets, wh packed in float32 as [H][H][4] (pack_wh: row k, unit j, gate g), T, B, H, the dtype
    flag, the rows and the shared memory; it counts one `lstm_seq_resident` and nothing else."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["114-13-0"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 1024, 64
    args = _inputs("lstm", T, B, H, dtype, "cpu")
    seen = {}
    lib = cuda_rnn.load_library()
    entry = lib.lstm_resident_forward

    def keeping(*call):
        seen["wh"] = _float_at(call[3], H * 4 * H)  # read while the launch holds it
        return entry(*call)

    keeping.__name__ = "lstm_resident_forward"
    lib.lstm_resident_forward = keeping
    before = cuda_rnn.launch_counts()
    out, state = cuda_rnn._launch_lstm(*args)
    plan = cuda_rnn.launch_plan("lstm", T, B, H, dtype, spec)
    assert plan.design == "resident" and plan != cuda_rnn.launch_plan("lstm", T, B, H, dtype)
    (name, call), = calls
    assert name == "lstm_resident_forward" and len(call) == 13 and call[:3] == (args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr())
    assert list(call[6:12]) == [T, B, H, int(dtype == "bfloat16"), plan.rows, plan.smem]
    packed = args[3].float().reshape(H, 4, H).permute(0, 2, 1)  # [k][j][g] = wh[k][g * H + j]
    assert np.array_equal(seen["wh"], packed.numpy().ravel())
    assert torch.equal(cuda_rnn.unpack_wh(cuda_rnn.pack_wh(args[3], plan), plan), args[3].float())
    assert out.shape == (T, B, H) and state.shape == args[1].shape
    after = cuda_rnn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident": 1}
    cuda_rnn._launches["lstm_seq_resident"] -= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_backward_launch_passes_the_plan(monkeypatch, dtype):
    """Where the forward takes the resident design, `_launch_bwd` launches `lstm_seq_resident_backward` with
    lstm_seq_backward's arguments (wh in float32 in place of wh^T), the resident backward's rows and shared memory on the
    tensor's card (66 SMs here); it counts one `lstm_seq_resident_bwd` and no other backward."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["66-7-3"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 1024, 64
    args = _cluster_bwd_args("lstm", T, B, H, dtype)
    before = cuda_rnn.launch_counts()
    outputs = cuda_rnn._launch_bwd("lstm", *args)
    plan = cuda_rnn.bwd_plan("lstm", B, H, dtype, spec)
    assert plan.design == "resident" and plan == cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True)
    (name, call), = calls
    assert name == "lstm_seq_resident_backward" and len(call) == 16
    assert call[:3] == tuple(a.data_ptr() for a in args[:3]) and call[3] == args[3].data_ptr() and call[4] == args[5].data_ptr()
    assert (call[5] == args[6].data_ptr()) == (dtype == "float32")
    assert list(call[9:15]) == [T, B, H, int(dtype == "bfloat16"), plan.rows, plan.smem]
    assert [tuple(o.shape) for o in outputs] == [tuple(args[3].shape), tuple(args[1].shape)] and outputs[0].dtype == args[3].dtype
    after = cuda_rnn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident_bwd": 1}
    cuda_rnn._launches["lstm_seq_resident_bwd"] -= 1


def test_the_resident_design_refuses_the_gru(monkeypatch):
    _fake_cuda(monkeypatch, [])
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    plan = cuda_rnn.resident_plan("lstm", 1024, 64, "float32")
    with pytest.raises(ValueError, match="the resident design takes the LSTM"):
        cuda_rnn._launch_gru(*_inputs("gru", 2, 1024, 64, "float32", "cpu"), plan=plan)
    with pytest.raises(ValueError, match="the resident backward takes the LSTM"):
        cuda_rnn._launch_bwd("gru", *_bwd_args("gru", 2, 1024, 64), plan=plan)


def test_a_refused_resident_launch_names_the_plan_and_the_sms(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    lib = cuda_rnn.load_library()
    lib.lstm_seq_resident_backward = lambda *args: 1  # cudaErrorInvalidValue
    lib.lstm_seq_resident_backward.__name__ = "lstm_seq_resident_backward"
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: SMALL_SPECS["114-13-0"])
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"lstm_seq_resident_backward launch failed: CUDA error 1 \(T=2, B=1024, H=64, torch.float32: "
                                           r"plan Plan\(design='resident'.*: 16 rows a block \(4 a thread\), 64 blocks of 256 threads, "
                                           r"99328 bytes of shared memory, on a card of 114 SMs"):
        cuda_rnn._launch_bwd("lstm", *_cluster_bwd_args("lstm", 2, 1024, 64))
    assert cuda_rnn.launch_counts() == before and calls == []


# S1: the grid forward at 8 x 8 register tiles (from GRID_WIDE_ROWS rows: float2 loads of x_proj) and the resident forward
# (16-byte copies of x_proj), each given a contiguous view of x_proj one float into its buffer
ODD_OFFSET_FORWARDS = [("lstm", 2, 1024, 512, "grid"), ("gru", 2, 1024, 512, "grid"), ("lstm", 2, 1024, 64, "resident")]


@pytest.mark.parametrize("kind,T,B,H,design", ODD_OFFSET_FORWARDS, ids=["-".join(map(str, s)) for s in ODD_OFFSET_FORWARDS])
def test_forward_copies_an_x_proj_at_an_odd_offset(monkeypatch, kind, T, B, H, design):
    """The grid and resident forwards read x_proj in pieces of up to 16 bytes: a view one float into a buffer reaches the
    kernel as a copy on 16 bytes with the same values; the other inputs pass as they are."""
    calls, seen = [], {}
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    args = _inputs(kind, T, B, H, "float32", "cpu")
    odd = torch.empty(args[0].numel() + 1)[1:].view_as(args[0]).copy_(args[0])
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    plan = cuda_rnn.launch_plan(kind, T, B, H, "float32")
    assert plan.design == design and (design != "grid" or (plan.tile_rows, plan.tile_cols) == (8, 8))
    name = {"grid": f"{kind}_grid_forward", "resident": f"{kind}_resident_forward"}[design]
    lib = cuda_rnn.load_library()
    entry = getattr(lib, name)

    def keeping(*call):
        seen["x_proj"] = _float_at(call[0], odd.numel())
        return entry(*call)

    keeping.__name__ = name
    setattr(lib, name, keeping)
    (cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm)(odd, *args[1:])
    (_, call), = calls
    assert call[0] % 16 == 0 and call[0] != odd.data_ptr() and call[1:3] == (args[1].data_ptr(), args[2].data_ptr())
    assert np.array_equal(seen["x_proj"], args[0].numpy().ravel())
    cuda_rnn._launches[cuda_rnn._kernel_name(kind, plan)] -= 1


# ------------------------------------------------------------------ the resident kernels' maps, emulated in float64 (CPU)

# shapes and cards that give each rows-a-thread the kernels are built for (4, 2, 1), a partly filled last block, and a width
# of one warp: (T, B, H, SMs) -> rows a block (rows a thread): 30 rows on 4 SMs -> 8 (4); 10 on 3 -> 4 (2); 3 on 2 -> 2 (1);
# 40 on 2 -> 32 (4, 512 threads); H=32: 30 on 4 -> 8 (2); DMLab's rollout shape on the H100 SXM -> 1 (1)
RESIDENT_EMULATED = [(5, 30, 64, 4), (4, 10, 64, 3), (3, 3, 64, 2), (2, 40, 64, 2), (4, 30, 32, 4), (3, 64, 64, 132)]


def _resident_map(plan, H):
    """Each thread's unit j (tid % H) and first row r0 (tid // H * rows a thread), as the kernels compute them."""
    tid = np.arange(plan.threads)
    return tid % H, tid // H * plan.tile_rows


def _check_banks(addresses, width):
    """A warp's shared-memory reads of `width` 4-byte words a lane at these word addresses: each 128-byte wavefront (8
    lanes of 16 bytes, 16 of 8, 32 of 4) touches each bank once, or every lane reads one address (a broadcast)."""
    addresses = np.asarray(addresses)
    if (addresses == addresses[0]).all():
        return
    lanes = 32 // width
    for phase in range(0, len(addresses), lanes):
        words = (addresses[phase:phase + lanes, None] + np.arange(width)).ravel()
        assert len(set(words % 32)) == len(words), f"bank conflict: {addresses[phase:phase + lanes]}"


def _sig(x):
    return 1.0 / (1.0 + np.exp(-np.maximum(x, -88.0)))


def _emulate_resident_forward(x, hc0, resets, wh, plan):
    """lstm_resident_kernel in float64, block by block, thread by thread as the kernel's map gives them: each thread's four
    gate sums of its rows over k in order, each row k's four gate weights read as one float4 from pack_wh's [H][H][4] at word
    (k * H + j) * 4 and each row's h[k] as one word (a warp's banks checked at block 0, step 0), the cell, outs and the carry.
    Returns (outs, hc_final) and checks that every (step, row, unit) is written once."""
    T, B, GH = x.shape
    H = GH // 4
    R, RT = plan.rows, plan.tile_rows
    j, r0 = _resident_map(plan, H)
    ws = cuda_rnn.pack_wh(torch.tensor(wh), plan).double().numpy().ravel()
    outs, hc_final, written = np.full((T, B, H), np.nan), np.full((B, 2 * H), np.nan), np.zeros((T, B, H), dtype=np.int64)
    for block in range(plan.grid):
        b0 = block * R
        live = min(R, B - b0)
        hs = np.zeros((2, R, H))
        hs[0, :live] = hc0[b0:b0 + live, :H]
        c = np.zeros((plan.threads, RT))
        for i in range(RT):
            m = r0 + i < live
            c[m, i] = hc0[b0 + r0[m] + i, H + j[m]]
        for t in range(T):
            s = t & 1
            acc = np.zeros((plan.threads, RT, 4))
            for k in range(H):
                h_at = s * R * H + (r0[:, None] + np.arange(RT)) * H + k  # each row's h[k]
                w_at = (k * H + j) * 4  # each thread's float4 of four gate weights
                if block == 0 and t == 0:
                    for warp in range(0, plan.threads, 32):
                        _check_banks(w_at[warp:warp + 32], 4)
                        for i in range(RT):
                            _check_banks(h_at[warp:warp + 32, i], 1)
                w = ws[w_at[:, None] + np.arange(4)]  # [thread][gate]
                for i in range(RT):
                    acc[:, i] += hs.ravel()[h_at[:, i]][:, None] * w
            new_carry = hs[s ^ 1]
            for i in range(RT):
                m = r0 + i < live
                rows, units = r0[m] + i, j[m]
                p = [x[t, b0 + rows, g * H + units] + acc[m, i, g] for g in range(4)]
                new_c = _sig(p[1] + 1.0) * c[m, i] + _sig(p[0]) * np.tanh(p[2])
                new_h = _sig(p[3]) * np.tanh(new_c)
                outs[t, b0 + rows, units] = new_h
                written[t, b0 + rows, units] += 1
                reset = resets[t, b0 + rows] > 0
                new_carry[rows, units] = np.where(reset, 0.0, new_h)
                c[m, i] = np.where(reset, 0.0, new_c)
        for i in range(RT):
            m = r0 + i < live
            hc_final[b0 + r0[m] + i, j[m]] = hs[T & 1, r0[m] + i, j[m]]
            hc_final[b0 + r0[m] + i, H + j[m]] = c[m, i]
    assert (written == 1).all(), "every (step, row, unit) cell is one thread's"
    return outs, hc_final


def _emulate_resident_backward(d_outs, d_final, resets, proj, hc0, wh, plan):
    """lstm_resident_bwd_kernel in float64, thread by thread: the cell state entering each step recomputed forward, then in
    reverse time each thread's cells (the gate cotangents into dg, the carried dh and dc in the thread), and dh[r][j] =
    dg[r][:] @ wh[j][:] in four partial sums, read as float4s from the padded rows (word j * (4H + 4) + q: a warp's banks checked at block 0, the
    last step) and from dg's broadcast rows. Returns (d_x_proj, d_hc0)."""
    T, B, GH = proj.shape
    H, WS = GH // 4, GH + 4
    R, RT = plan.rows, plan.tile_rows
    j, r0 = _resident_map(plan, H)
    ws = np.zeros((H, WS))
    ws[:, :GH] = wh
    ws = ws.ravel()
    d_x, d_state0 = np.full((T, B, GH), np.nan), np.full((B, 2 * H), np.nan)
    for block in range(plan.grid):
        b0 = block * R
        live = min(R, B - b0)
        valid = [r0 + i < live for i in range(RT)]
        rows = [r0 + i for i in range(RT)]
        cells = np.zeros((T, plan.threads, RT))
        c = np.zeros((plan.threads, RT))
        for i in range(RT):
            c[valid[i], i] = hc0[b0 + rows[i][valid[i]], H + j[valid[i]]]
        for t in range(T):
            cells[t] = c
            for i in range(RT):
                m = valid[i]
                a = proj[t, b0 + rows[i][m]]
                new_c = _sig(a[np.arange(m.sum()), H + j[m]] + 1.0) * c[m, i] + _sig(a[np.arange(m.sum()), j[m]]) * np.tanh(a[np.arange(m.sum()), 2 * H + j[m]])
                c[m, i] = np.where(resets[t, b0 + rows[i][m]] > 0, 0.0, new_c)
        dh, dc = np.zeros((plan.threads, RT)), np.zeros((plan.threads, RT))
        for i in range(RT):
            m = valid[i]
            dh[m, i], dc[m, i] = d_final[b0 + rows[i][m], j[m]], d_final[b0 + rows[i][m], H + j[m]]
        for t in reversed(range(T)):
            dg = np.zeros((R, GH))  # rows past B stay zero
            for i in range(RT):
                m = valid[i]
                b, u = b0 + rows[i][m], j[m]
                pi, pf, pg, po = (proj[t, b, g * H + u] for g in range(4))
                si, sf, so, tg = _sig(pi), _sig(pf + 1.0), _sig(po), np.tanh(pg)
                dsi, dsf, dso = (np.where(v < -88.0, 0.0, s * (1.0 - s)) for v, s in ((pi, si), (pf + 1.0, sf), (po, so)))
                cv = cells[t][m, i]
                tc = np.tanh(sf * cv + si * tg)
                keep = ~(resets[t, b] > 0)
                gh = d_outs[t, b, u] + np.where(keep, dh[m, i], 0.0)
                gc = np.where(keep, dc[m, i], 0.0)
                dct = gc + gh * so * (1.0 - tc * tc)
                grads = [dct * tg * dsi, dct * cv * dsf, dct * si * (1.0 - tg * tg), gh * tc * dso]
                dc[m, i] = dct * sf
                for g in range(4):
                    d_x[t, b, g * H + u] = grads[g]
                    dg[rows[i][m], g * H + u] = grads[g]
            acc = np.zeros((plan.threads, RT, 4))  # four partial sums a row: columns 4q + e
            for q in range(0, GH, 4):
                w_at = j * WS + q
                if block == 0 and t == T - 1:
                    for warp in range(0, plan.threads, 32):
                        _check_banks(w_at[warp:warp + 32], 4)
                        for i in range(RT):
                            _check_banks(rows[i][warp:warp + 32] * GH + q, 4)
                w = ws[w_at[:, None] + np.arange(4)]  # [thread][4]
                for i in range(RT):
                    acc[:, i] += dg[np.minimum(rows[i], R - 1), q:q + 4] * (rows[i] < R)[:, None] * w
            dh = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
        for i in range(RT):
            m = valid[i]
            d_state0[b0 + rows[i][m], j[m]] = dh[m, i]
            d_state0[b0 + rows[i][m], H + j[m]] = dc[m, i]
    return d_x, d_state0


def _resident_emulated_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, 4 * H))
    x[:, : max(1, B // 4), 3 * H:] = -200.0  # gates below -88 (o) on the first quarter of the rows
    hc0 = rng.normal(size=(B, 2 * H))
    resets = (rng.random((T, B)) < 0.3).astype(np.float64)
    resets[:, -1] = 1.0  # the last row reset at every step
    wh = rng.normal(size=(H, 4 * H)) / math.sqrt(H)
    return x, hc0, resets, wh


@pytest.mark.parametrize("T,B,H,sms", RESIDENT_EMULATED, ids=["-".join(map(str, s)) for s in RESIDENT_EMULATED])
def test_resident_forward_emulated_in_float64(T, B, H, sms):
    """lstm_resident_kernel's thread map and wh layout, emulated in float64: every cell is one thread's, every read of wh
    and h falls in distinct banks or is a broadcast, and the result is lstm_seq_reference's (in float64; the plain version
    keeps its carries in float32, hence the tolerance)."""
    spec = cuda_rnn.CardSpec(sms, 0, 0, 232_448)
    plan = cuda_rnn.resident_plan("lstm", B, H, "float32", spec)
    assert plan.rows * plan.grid >= B and plan.threads % 32 == 0 or plan.threads == H
    x, hc0, resets, wh = _resident_emulated_inputs(T, B, H, seed=T + B + H)
    outs, hc_final = _emulate_resident_forward(x, hc0, resets, wh, plan)
    ref_out, ref_state = cuda_rnn.lstm_seq_reference(*(torch.tensor(a) for a in (x, hc0, resets, wh)))
    np.testing.assert_allclose(outs, ref_out.double().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hc_final, ref_state.double().numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,B,H,sms", RESIDENT_EMULATED, ids=["-".join(map(str, s)) for s in RESIDENT_EMULATED])
def test_resident_backward_emulated_in_float64(T, B, H, sms):
    """lstm_resident_bwd_kernel's thread map and padded wh rows, emulated in float64: the recomputed cell state, each
    thread's cells and its column of dh_prev (reads of wh's padded rows in distinct banks, of dg as broadcasts) give
    lstm_seq_bwd_reference's d_x_proj and d_hc0, gates below -88 a zero gradient."""
    spec = cuda_rnn.CardSpec(sms, 0, 0, 232_448)
    plan = cuda_rnn.resident_plan("lstm", B, H, "float32", spec, backward=True)
    x, hc0, resets, wh = _resident_emulated_inputs(T, B, H, seed=T + B + H + 1)
    rng = np.random.default_rng(B)
    d_outs, d_final = rng.normal(size=(T, B, H)), rng.normal(size=(B, 2 * H))
    h_prev = np.concatenate([hc0[None, :, :H], rng.normal(size=(T - 1, B, H))]) * 0.5
    # float32 values (the plain version's backward takes float32 or bf16), emulated in float64
    inputs = [a.astype(np.float32) for a in (d_outs, d_final, resets, x + h_prev @ wh, hc0, wh)]
    d_x, d_state0 = _emulate_resident_backward(*(a.astype(np.float64) for a in inputs), plan)
    want_x, want_state = cuda_rnn.lstm_seq_bwd_reference(*(torch.tensor(a) for a in inputs))
    scale = max(1.0, float(want_x.abs().max()), float(want_state.abs().max()))
    np.testing.assert_allclose(d_x, want_x.double().numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(d_state0, want_state.double().numpy(), rtol=0, atol=1e-5 * scale)
    saturated = max(1, B // 4)
    assert (d_x[:, :saturated, 3 * H:] == 0).all()


# ------------------------------------------------------------------ the resident kernels on the card

# DMLab's sites, and odd shapes: B not a multiple of the rows a block (1001 rows in blocks of 8), B=1, T=1, and CARD_SHAPES' (5, 3, 64)
RESIDENT_CARD_SHAPES = [(T, B, H, dtype) for T, B, H in [(16, 64, 64), (16, 128, 64), (16, 1024, 64), (16, 2048, 64), (5, 1001, 64),
                                                         (3, 1, 64), (1, 1024, 64), (5, 3, 64)] for dtype in ("float32", "bfloat16")]


def _resident_card_plans(cuda_device, B, H, dtype):
    spec = cuda_rnn.card_spec(cuda_device)
    return cuda_rnn.resident_plan("lstm", B, H, dtype, spec), cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", RESIDENT_CARD_SHAPES, ids=["-".join(map(str, s)) for s in RESIDENT_CARD_SHAPES])
def test_resident_kernels_match_plain_on_card(cuda_device, T, B, H, dtype):
    """`lstm_seq_resident` against lstm_seq_reference and `lstm_seq_resident_bwd` against lstm_seq_bwd_reference on the same
    inputs, forward at the other card tests' tolerance, backward within BWD_TOL; one launch of each, no other."""
    fwd, bwd = _resident_card_plans(cuda_device, B, H, dtype)
    args = _inputs("lstm", T, B, H, dtype, cuda_device, seed=17)
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    with torch.no_grad():
        cuda_rnn.reset_launch_counts()
        out, state = cuda_rnn._launch_lstm(*args, plan=fwd)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq_resident": 1}
        ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
        torch.testing.assert_close(out, ref_out, atol=tol, rtol=0)
        torch.testing.assert_close(state, ref_state, atol=tol, rtol=0)
        d_out, d_state = _cotangents(out, state)
        h_in = cuda_rnn._carries_in(args[1], args[2], out).to(args[0].dtype)
        rec = (d_out, d_state, args[2], args[0] + h_in @ args[3], args[1], args[3])
        got = cuda_rnn._launch_lstm_bwd(*rec, plan=bwd)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts()["lstm_seq_resident_bwd"] == 1
        want = cuda_rnn.lstm_seq_bwd_reference(*rec)
    assert all(g.dtype == w.dtype and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_kernels_on_resets_and_saturated_gates(cuda_device, dtype):
    """The resident design at DMLab's learner shape: every second row reset at every step and sigmoid gates below -88:
    finite outputs and gradients, the saturated gates' exactly 0, equal to the plain versions'."""
    T, B, H = 16, 1024, 64
    fwd, bwd = _resident_card_plans(cuda_device, B, H, dtype)
    args = _masked_inputs("lstm", T, B, H, dtype, cuda_device)
    for g in (0, 1, 3):
        args[0][:, :64, g * H:(g + 1) * H] = -200.0
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    with torch.no_grad():
        out, state = cuda_rnn._launch_lstm(*args, plan=fwd)
        ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
        assert bool(torch.isfinite(out).all()) and bool((state[1::2] == 0).all())
        torch.testing.assert_close(out, ref_out, atol=tol, rtol=0)
        torch.testing.assert_close(state, ref_state, atol=tol, rtol=0)
        h_in = cuda_rnn._carries_in(args[1], args[2], out).to(args[0].dtype)
        rec = (*_cotangents(out, state), args[2], args[0] + h_in @ args[3], args[1], args[3])
        got = cuda_rnn._launch_lstm_bwd(*rec, plan=bwd)
        want = cuda_rnn.lstm_seq_bwd_reference(*rec)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g in (0, 1, 3):
        assert bool((got[0][:, :64, g * H:(g + 1) * H] == 0).all()), f"gate {g} below -88 has a gradient"
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_gradient_through_the_resident_design_at_dmlab_learner(cuda_device):
    """`lstm_seq` at DMLab's learner shape takes the resident design forward and backward (one launch of each), and its
    gradients match autograd through the plain forward within chip_smoke.py's GRAD_F32_TOL."""
    T, B, H = 16, 1024, 64
    assert cuda_rnn.launch_plan("lstm", T, B, H, "float32", cuda_rnn.card_spec(cuda_device)).design == "resident"
    args = [a.requires_grad_(i != 2) for i, a in enumerate(_inputs("lstm", T, B, H, "float32", cuda_device, seed=19))]
    cuda_rnn.reset_launch_counts()
    out, state = cuda_rnn.lstm_seq(*args)
    wrt = [a for i, a in enumerate(args) if i != 2]
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    torch.cuda.synchronize()
    assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq_resident": 1, "lstm_seq_resident_bwd": 1}
    ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) / max(1.0, float(r.abs().max())) <= 1e-4  # chip_smoke.GRAD_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T,B,H,design", ODD_OFFSET_FORWARDS, ids=["-".join(map(str, s)) for s in ODD_OFFSET_FORWARDS])
def test_forward_on_an_x_proj_at_an_odd_offset_matches_plain_on_card(cuda_device, kind, T, B, H, design):
    """S1: a contiguous float32 x_proj one float into its buffer (the grid design at 8 x 8 tiles, the resident design)
    launches the planned kernel and matches the plain version."""
    args = _inputs(kind, T, B, H, "float32", cuda_device, seed=21)
    odd = torch.empty(args[0].numel() + 1, device=cuda_device)[1:].view_as(args[0]).copy_(args[0])
    assert odd.data_ptr() % 16
    assert cuda_rnn.launch_plan(kind, T, B, H, "float32", cuda_rnn.card_spec(cuda_device)).design == design
    with torch.no_grad():
        out, state = _fns(kind)[0](odd, *args[1:])
        torch.cuda.synchronize()
        ref_out, ref_state = _fns(kind)[1](*args)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    torch.testing.assert_close(state, ref_state, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ lstm_seq_in: the resident design with the input product folded in

IN_WIDTH = 20  # DMLab's instruction embedding, the width of the instruction encoder's LSTM-64 input


def _in_inputs(T, B, H, dtype, device, seed=0, I=IN_WIDTH):
    """lstm_seq_in's inputs as the instruction encoder gives them: x [T,B,I] a transposed view of [B,T,I], wi, bi, hc0,
    resets, wh, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.normal(size=(B, T, I)).astype(np.float32), device=device).to(dt).transpose(0, 1)
    wi = torch.tensor((rng.normal(size=(I, 4 * H)) / math.sqrt(I)).astype(np.float32), device=device).to(dt)
    bi = torch.tensor((rng.normal(size=(4 * H,)) * 0.1).astype(np.float32), device=device).to(dt)
    hc0 = torch.tensor(rng.normal(size=(B, 2 * H)).astype(np.float32), device=device)
    resets = torch.tensor((rng.random((T, B)) < 0.1).astype(np.float32), device=device)
    wh = torch.tensor((rng.normal(size=(H, 4 * H)) / math.sqrt(H)).astype(np.float32), device=device).to(dt)
    return [x, wi, bi, hc0, resets, wh]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


IN_PLAN_SHAPES = RESIDENT_SITES + [(32, 1024, 64, "float32"), (16, 1001, 64, "float32"), (16, 2048, 64, "float32"),
                                   (16, 4096, 64, "float32")]
IN_PLANS = [pytest.param(T, B, H, dtype, name, id=f"{T}-{B}-{H}-{dtype}" + (f"-{name}" if name else ""))
            for T, B, H, dtype in IN_PLAN_SHAPES for name in RESIDENT_SPECS]


@pytest.mark.parametrize("T,B,H,dtype,name", IN_PLANS)
def test_resident_in_plans_take_the_resident_forwards_blocks(T, B, H, dtype, name):
    """lstm_seq_in's plan, on the H100 SXM and the smaller cards, wherever the forward takes the resident design: the resident
    forward's rows and blocks with twice its threads (the consumers and as many producers), x of all T steps staged, the
    shared memory the kernel's formula; no plan where the threads would exceed RESIDENT_MAX_THREADS (the resident blocks at
    4096 rows have 512 already) or the shared memory the card's limit."""
    spec = RESIDENT_SPECS[name]
    fwd = cuda_rnn.resident_plan("lstm", B, H, dtype, spec)
    assert cuda_rnn.launch_plan("lstm", T, B, H, dtype, spec).design == "resident"
    plan = cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, getattr(torch, dtype), spec)
    smem = cuda_rnn.resident_in_smem(H, fwd.rows, IN_WIDTH, T, 2 if dtype == "bfloat16" else 4)
    if 2 * fwd.threads > cuda_rnn.RESIDENT_MAX_THREADS or smem > spec.smem_limit:
        assert plan is None
        return
    assert plan.design == "resident_in" and plan == cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, dtype, spec)
    assert (plan.rows, plan.grid, plan.tile_rows, plan.threads) == (fwd.rows, fwd.grid, fwd.tile_rows, 2 * fwd.threads)
    assert plan.smem == smem <= spec.smem_limit
    if name == "" and T == 16 and B in (64, 128, 1024, 2048):
        assert (plan.threads, plan.smem) == {64: (128, 89_856), 128: (128, 89_856), 1024: (256, 116_736),
                                             2048: (512, 190_464 if dtype == "bfloat16" else 147_456)}[B]
    if B == 4096:
        assert plan is None


def test_resident_in_takes_no_shape_the_resident_design_does_not():
    """No fused plan where the forward takes another design (the DMLab core's LSTM-256, the GRU), nor without an input; the
    route there is the Linear, then lstm_seq."""
    assert cuda_rnn.resident_in_plan(32, 32, 256, 20, torch.float32) is None
    assert cuda_rnn.resident_in_plan(16, 1024, 60, 20, torch.float32) is None
    assert cuda_rnn.resident_in_plan(16, 1024, 64, 0, torch.float32) is None
    assert cuda_rnn.resident_in_plan(16, 4096, 64, 20, torch.float32) is None  # 512 resident threads already: no room for producers
    assert cuda_rnn.in_route("cpu", 16, 1024, 64, 20, torch.float32) == "plain"


def _in_cxx():
    """A host program of the fused forward's shared-memory formula, csrc/rnn_seq.cu's own text, for g++."""
    source = cuda_rnn.SOURCE.read_text()
    parts = [re.search(r"__host__ __device__ constexpr size_t align16\(size_t n\) \{[^}]*\}", source).group(0),
             re.search(r"__host__ __device__ constexpr int resident_in_pad\(int I\) \{[^}]*\}", source).group(0),
             re.search(r"inline size_t resident_in_smem_bytes\(.*?\n\}", source, re.S).group(0)]
    return ("#include <cstddef>\n#include <cstdio>\n#include <cstdlib>\n#define __host__\n#define __device__\n" + "\n".join(parts)
            + "\nint main(int argc, char** argv) { for (int i = 1; i + 4 < argc; i += 5) { std::printf(\"%zu\\n\", resident_in_smem_bytes("
              "atoi(argv[i]), atoi(argv[i + 1]), atoi(argv[i + 2]), atoi(argv[i + 3]), atoi(argv[i + 4]))); } return 0; }\n")


def test_resident_in_smem_is_the_kernels(tmp_path):
    """resident_in_smem in Python equals the kernel source's resident_in_smem_bytes (compiled for the host with g++)."""
    if not shutil.which("g++"):
        pytest.skip("needs g++ to compile the kernel source's formula for the host")
    (tmp_path / "resident_in.cpp").write_text(_in_cxx())
    subprocess.run(["g++", "-std=c++17", "-O0", "-o", str(tmp_path / "resident_in"), str(tmp_path / "resident_in.cpp")], check=True)
    cases = [(H, R, I, T, item) for H in (8, 64) for R in (1, 3, 8, 16) for I in (1, 20, 21) for T in (1, 7, 16) for item in (2, 4)]
    out = subprocess.run([str(tmp_path / "resident_in"), *[str(v) for case in cases for v in case]], capture_output=True, text=True,
                         check=True).stdout.split()
    assert [int(v) for v in out] == [cuda_rnn.resident_in_smem(*case) for case in cases]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_in_launch_passes_x_at_its_strides_and_the_weights_as_given(monkeypatch, dtype, save):
    """At DMLab's learner shape on a card of 114 SMs, `_launch_lstm_in` launches `lstm_resident_in_forward` once with x's own
    pointer and strides (the encoder's transposed view: no copy), wi, bi, hc0, resets and wh as they are (the kernel lays wi and
    wh out in shared memory: no packing launch), the outputs, the backward's three buffers (null without `save`), T, B, H, I,
    xh's width, the dtype flag and the plan's rows and shared memory; it counts one `lstm_seq_resident_in`."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["114-13-0"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 3, 1024, 64
    args = _in_inputs(T, B, H, dtype, "cpu")
    before = cuda_rnn.launch_counts()
    outs, state, *saved = cuda_rnn._launch_lstm_in(*args, save=save)
    plan = cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, getattr(torch, dtype), spec)
    assert plan.rows == cuda_rnn.resident_plan("lstm", B, H, dtype, spec).rows
    (name, call), = calls
    K = cuda_rnn.in_width(IN_WIDTH, H)
    assert name == "lstm_resident_in_forward" and len(call) == 22 and not args[0].is_contiguous()
    assert call[:8] == tuple(t.data_ptr() for t in (*args, outs, state))
    assert call[8:11] == (tuple(t.data_ptr() for t in saved) if save else (None, None, None))
    assert call[11:13] == (args[0].stride(0), args[0].stride(1)) == (IN_WIDTH, T * IN_WIDTH)
    assert list(call[13:21]) == [T, B, H, IN_WIDTH, K, int(dtype == "bfloat16"), plan.rows, plan.smem]
    assert outs.shape == (T, B, H) and state.shape == args[3].shape
    if save:
        assert [tuple(t.shape) for t in saved] == [(T, B, 4 * H), (T, B, H), (T, B, K)]
        assert [t.dtype for t in saved] == [args[0].dtype, torch.float32, args[0].dtype]
    after = cuda_rnn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident_in": 1}
    cuda_rnn._launches["lstm_seq_resident_in"] -= 1


def test_resident_in_backward_launch_passes_the_saved_buffers(monkeypatch):
    """`_launch_lstm_in_bwd` launches `lstm_seq_resident_in_backward` with the forward's saved proj and cell states, a null final
    cotangent where none is given, wh in float32 and the resident backward's rows and shared memory (66 SMs here); it counts
    one `lstm_seq_resident_in_bwd`."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    spec = SMALL_SPECS["66-7-3"]
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: spec)
    T, B, H = 2, 1024, 64
    d_out, _, resets, proj, _, hc0, wh = _bwd_args("lstm", T, B, H)
    cells = torch.zeros(T, B, H)
    before = cuda_rnn.launch_counts()
    d_proj, d_hc0 = cuda_rnn._launch_lstm_in_bwd(d_out, None, resets, proj, hc0, wh, cells)
    plan = cuda_rnn.resident_plan("lstm", B, H, "float32", spec, backward=True)
    (name, call), = calls
    assert name == "lstm_seq_resident_in_backward" and len(call) == 16
    assert call[:9] == (d_out.data_ptr(), None, resets.data_ptr(), proj.data_ptr(), hc0.data_ptr(), wh.data_ptr(), cells.data_ptr(),
                        d_proj.data_ptr(), d_hc0.data_ptr())
    assert list(call[9:15]) == [T, B, H, 0, plan.rows, plan.smem]
    after = cuda_rnn.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident_in_bwd": 1}
    cuda_rnn._launches["lstm_seq_resident_in_bwd"] -= 1


def test_a_refused_resident_in_launch_raises(monkeypatch):
    """No fallback: a fused launch the card refuses raises with the plan and the card, and counts nothing."""
    _fake_cuda(monkeypatch, [])
    lib = cuda_rnn.load_library()
    lib.lstm_resident_in_forward = lambda *args: 1  # cudaErrorInvalidValue
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    before = cuda_rnn.launch_counts()
    with pytest.raises(RuntimeError, match=r"lstm_resident_in_forward launch failed: CUDA error 1 \(T=2, B=1024, I=20, H=64, "
                                           r"torch.float32: plan Plan\(design='resident_in'.*on a card of 132 SMs"):
        cuda_rnn._launch_lstm_in(*_in_inputs(2, 1024, 64, "float32", "cpu"))
    assert cuda_rnn.launch_counts() == before


def test_lstm_seq_in_routes_other_cuda_shapes_to_the_linear_and_lstm_seq(monkeypatch):
    """Where in_route gives "unfused" (a CUDA shape without a fused plan), lstm_seq_in is x @ wi + bi, then lstm_seq."""
    seen = []
    monkeypatch.setattr(cuda_rnn, "in_route", lambda *args: "unfused")
    monkeypatch.setattr(cuda_rnn, "lstm_seq", lambda *args: seen.append(args) or ("outs", "state"))
    x, wi, bi, hc0, resets, wh = _in_inputs(3, 5, 16, "float32", "cpu")
    assert cuda_rnn.lstm_seq_in(x, wi, bi, hc0, resets, wh) == ("outs", "state")
    (x_proj, *rest), = seen
    assert torch.equal(x_proj, x @ wi + bi) and x_proj.is_contiguous() and all(a is b for a, b in zip(rest, (hc0, resets, wh)))


def test_in_route_on_a_card(monkeypatch):
    """On a CUDA device: "fused" at DMLab's instruction-encoder sites, "unfused" where the forward takes another design."""
    _fake_cuda(monkeypatch, [])
    monkeypatch.setattr(cuda_rnn, "card_spec", lambda device: cuda_rnn.H100_SXM)
    for T, B, H, dtype in RESIDENT_SITES:
        assert cuda_rnn.in_route("cuda", T, B, H, IN_WIDTH, getattr(torch, dtype)) == "fused"
    assert cuda_rnn.in_route("cuda", 32, 32, 256, IN_WIDTH, torch.float32) == "unfused"


# DMLab's sites, (16, 2048, 64), and odd shapes: 1001 rows (a partly filled last block), B=1, T=1, (5, 3, 64)
IN_CARD_SHAPES = RESIDENT_CARD_SHAPES


def _in_card_plans(cuda_device, T, B, H, dtype):
    spec = cuda_rnn.card_spec(cuda_device)
    return (cuda_rnn.resident_in_plan(T, B, H, IN_WIDTH, getattr(torch, dtype), spec),
            cuda_rnn.resident_plan("lstm", B, H, dtype, spec, backward=True))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", IN_CARD_SHAPES, ids=["-".join(map(str, s)) for s in IN_CARD_SHAPES])
def test_resident_in_kernels_match_plain_on_card(cuda_device, T, B, H, dtype):
    """`lstm_seq_resident_in` against lstm_seq_in_reference, forward at the other card tests' tolerance, with and without the
    backward's buffers (the same outputs either way; the buffers against lstm_seq_in_saved_reference's at that tolerance
    relative to their largest value, x's columns of xh exact); `lstm_seq_resident_in_bwd` on those buffers against
    lstm_seq_bwd_reference within BWD_TOL; the launches of each, no other."""
    fwd, bwd = _in_card_plans(cuda_device, T, B, H, dtype)
    args = _in_inputs(T, B, H, dtype, cuda_device, seed=23)
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    with torch.no_grad():
        cuda_rnn.reset_launch_counts()
        out, state, *none = cuda_rnn._launch_lstm_in(*args, plan=fwd)
        torch.cuda.synchronize()
        assert none == [None, None, None]
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq_resident_in": 1}
        ref = cuda_rnn.lstm_seq_in_saved_reference(*args)
        torch.testing.assert_close(out, ref[0], atol=tol, rtol=0)
        torch.testing.assert_close(state, ref[1], atol=tol, rtol=0)
        out2, state2, proj, cells, xh = cuda_rnn._launch_lstm_in(*args, save=True, plan=fwd)
        assert torch.equal(out2, out) and torch.equal(state2, state)
        for got, want in zip((proj, cells, xh), ref[2:]):
            assert _rel(got, want) <= tol
        assert torch.equal(xh[..., :IN_WIDTH], args[0]) and torch.equal(xh[..., IN_WIDTH + H:], ref[4][..., IN_WIDTH + H:])
        d_out, d_state = _cotangents(out, state)
        got = cuda_rnn._launch_lstm_in_bwd(d_out, d_state, args[4], proj, args[3], args[5], cells, plan=bwd)
        torch.cuda.synchronize()
        assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq_resident_in": 2,
                                            "lstm_seq_resident_in_bwd": 1}
        want = cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, args[4], proj, args[3], args[5], cells)
    assert all(g.dtype == w.dtype and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_in_kernels_on_resets_and_saturated_gates(cuda_device, dtype):
    """At DMLab's learner shape: every second row reset at every step, and the first 64 rows' sigmoid gates below -88 (their x
    drives them there through one column of wi): finite outputs and gradients, the saturated gates' exactly 0, the plain
    versions' results."""
    T, B, H = 16, 1024, 64
    fwd, bwd = _in_card_plans(cuda_device, T, B, H, dtype)
    x, wi, bi, hc0, resets, wh = args = _in_inputs(T, B, H, dtype, cuda_device, seed=29)
    resets[:, 1::2] = 1.0
    gates = torch.cat([torch.arange(g * H, (g + 1) * H) for g in (0, 1, 3)])
    wi[0] = 0.0
    wi[0, gates] = -1.0
    x[:, :, 0] = 0.0
    x[:, :64, 0] = 300.0
    tol = 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_ATOL
    with torch.no_grad():
        out, state, proj, cells, xh = cuda_rnn._launch_lstm_in(*args, save=True, plan=fwd)
        ref = cuda_rnn.lstm_seq_in_saved_reference(*args)
        assert bool(torch.isfinite(out).all()) and bool((state[1::2] == 0).all()) and bool((proj[:, :64, gates] < -88).all())
        torch.testing.assert_close(out, ref[0], atol=tol, rtol=0)
        torch.testing.assert_close(state, ref[1], atol=tol, rtol=0)
        d_out, d_state = _cotangents(out, state)
        got = cuda_rnn._launch_lstm_in_bwd(d_out, d_state, resets, proj, hc0, wh, cells, plan=bwd)
        want = cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, resets, proj, hc0, wh, cells)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert bool((got[0][:, :64, gates] == 0).all()), "a gate below -88 has a gradient"
    assert _bwd_rel_err(got, want) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["transposed", "odd_offset"])
def test_gradient_through_lstm_seq_in_at_dmlab_learner(cuda_device, layout):
    """`lstm_seq_in` at DMLab's learner shape, on the encoder's transposed x or a contiguous x one float into its buffer: one
    launch of each fused kernel and no other RNN kernel, its outputs and the gradients of x, wi, bi, hc0 and wh within
    chip_smoke.py's tolerances (the forward's 1e-4 x T/4, GRAD_F32_TOL) of autograd through the plain version."""
    T, B, H = 16, 1024, 64
    args = _in_inputs(T, B, H, "float32", cuda_device, seed=31)
    if layout == "odd_offset":
        args[0] = torch.empty(args[0].numel() + 1, device=cuda_device)[1:].view(T, B, IN_WIDTH).copy_(args[0])
        assert args[0].data_ptr() % 16 and args[0].is_contiguous()
    assert cuda_rnn.in_route(cuda_device, T, B, H, IN_WIDTH, torch.float32) == "fused"
    args = [a.requires_grad_(i != 4) for i, a in enumerate(args)]
    wrt = [a for i, a in enumerate(args) if i != 4]
    cuda_rnn.reset_launch_counts()
    out, state = cuda_rnn.lstm_seq_in(*args)
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    torch.cuda.synchronize()
    assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq_resident_in": 1,
                                        "lstm_seq_resident_in_bwd": 1}
    ref_out, ref_state = cuda_rnn.lstm_seq_in_reference(*args)
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    torch.testing.assert_close(out, ref_out, atol=4e-4, rtol=0)
    torch.testing.assert_close(state, ref_state, atol=4e-4, rtol=0)
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-4  # chip_smoke.GRAD_F32_TOL


@pytest.mark.cuda
def test_lstm_seq_in_keeps_the_unfused_route_at_the_dmlab_core(cuda_device):
    """At the DMLab core's (32, 32, 256), which takes the cluster design, lstm_seq_in is the Linear, then `lstm_seq`: one
    `lstm_seq` and one `lstm_seq_cluster_bwd`, no fused kernel; its gradients those of the plain version."""
    T, B, H = 32, 32, 256
    args = [a.requires_grad_(i != 4) for i, a in enumerate(_in_inputs(T, B, H, "float32", cuda_device, seed=37))]
    wrt = [a for i, a in enumerate(args) if i != 4]
    cuda_rnn.reset_launch_counts()
    out, state = cuda_rnn.lstm_seq_in(*args)
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    torch.cuda.synchronize()
    assert cuda_rnn.launch_counts() == {**{k: 0 for k in cuda_rnn.launch_counts()}, "lstm_seq": 1, "lstm_seq_cluster_bwd": 1}
    ref_out, ref_state = cuda_rnn.lstm_seq_in_reference(*args)
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    torch.testing.assert_close(out, ref_out, atol=8e-4, rtol=0)
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-4


def test_the_profilers_rnn_kernels_name_every_kernel_of_the_source():
    """Every `__global__` kernel of csrc/rnn_seq.cu is counted among the RNN kernels by `utils/device_profile.py`, which adds
    up their device time in chip_smoke.py's and bench_gpu.py's profiles (by a part of the symbol's name)."""
    from sample_factory_tpu_torch.utils.device_profile import RNN_KERNELS

    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\(", cuda_rnn.SOURCE.read_text())
    assert "lstm_resident_in_kernel" in names and len(names) >= 9
    assert all(any(k in name for k in RNN_KERNELS) for name in names), names
