"""The port's GRU/LSTM sequence ops (ops/cuda_rnn.py) against the JAX package.

On the CPU the port runs the kernels' plain versions; they are held against
the JAX scan references and against the Pallas kernels run in interpret mode,
as tests/test_pallas_gru.py runs them. Tolerances follow that file: the
recurrence amplifies f32 reassociation drift (~1e-6/step), so they scale with
T. The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda_kernels.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.ops.pallas_gru import (
    gru_seq_reference as jax_gru_reference,
    lstm_seq_reference as jax_lstm_reference,
    pallas_gru_seq,
    pallas_lstm_seq,
)
from sample_factory_tpu_torch.ops import cuda_rnn

torch.set_num_threads(1)

SHAPES = [(5, 16, 128), (32, 16, 256), (7, 24, 128), (1, 8, 128)]
# and the GRU at H=512 in float32, the width of its grid design's sites on the card (Doom's learner,
# the multichip configuration, the default flags), at a depth that keeps the interpreted kernel quick
GRU_512 = (8, 16, 512)
# bf16: both sides round every gate op to bf16, but XLA on the CPU may keep some
# intermediates in f32 ("excess precision"), so single values can differ by a
# couple of bf16 ulps at magnitude ~1-2 (one ulp = 2^-7 .. 2^-6), and a flip
# feeds forward through the recurrence.
BF16_ATOL = 0.03  # measured up to 0.0078 on the CPU (one bf16 ulp at magnitude 1-2)


def _inputs(kind, T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    state = H if kind == "gru" else 2 * H
    x = rng.normal(size=(T, B, G * H)).astype(np.float32)
    s0 = rng.normal(size=(B, state)).astype(np.float32)
    resets = (rng.random((T, B)) < 0.2).astype(np.float32)
    wh = (rng.normal(size=(H, G * H)) * 0.1).astype(np.float32)
    bh = (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    return (x, s0, resets, wh, bh) if kind == "gru" else (x, s0, resets, wh)


def _jax_fns(kind):
    return (jax_gru_reference, pallas_gru_seq) if kind == "gru" else (jax_lstm_reference, pallas_lstm_seq)


def _port_fns(kind):
    return (cuda_rnn.gru_seq_reference, cuda_rnn.gru_seq) if kind == "gru" else (cuda_rnn.lstm_seq_reference, cuda_rnn.lstm_seq)


@pytest.mark.parametrize("T,B,H,kind", [(*shape, kind) for shape in SHAPES for kind in ("gru", "lstm")] + [(*GRU_512, "gru")])
def test_plain_matches_jax_reference_and_pallas(kind, T, B, H):
    args = _inputs(kind, T, B, H)
    jax_ref, jax_kernel = _jax_fns(kind)
    o_ref, s_ref = jax_ref(*map(jnp.asarray, args))
    o_pal, s_pal = jax_kernel(*map(jnp.asarray, args))  # interpret mode on the CPU
    o, s = _port_fns(kind)[1](*map(torch.tensor, args))
    tol = 1e-4 * max(1, T // 4)
    for want in ((o_ref, s_ref), (o_pal, s_pal)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want[0]), atol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), atol=tol)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_plain_bf16_matches_jax_reference(kind):
    T, B, H = 7, 24, 128
    args = _inputs(kind, T, B, H, seed=1)
    bf16 = [0, 3, 4]  # x_proj, wh, bh are in the compute dtype; states and resets stay f32
    jargs = [jnp.asarray(a, jnp.bfloat16) if i in bf16 else jnp.asarray(a) for i, a in enumerate(args)]
    targs = [torch.tensor(a).bfloat16() if i in bf16 else torch.tensor(a) for i, a in enumerate(args)]
    o_ref, s_ref = _jax_fns(kind)[0](*jargs)
    o, s = _port_fns(kind)[1](*targs)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=BF16_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=BF16_ATOL)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_resets_zero_carry_not_output(kind):
    """Output at step t is pre-reset; the carry into t+1 is zeroed."""
    T, B, H = 3, 8, 128
    args = list(_inputs(kind, T, B, H, seed=3))
    args[2] = np.zeros((T, B), np.float32)
    args[2][1, :] = 1.0  # reset after consuming step 1
    o, s = _port_fns(kind)[1](*map(torch.tensor, args))
    o_ref, _ = _jax_fns(kind)[0](*map(jnp.asarray, args))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-4)
    assert not np.allclose(o[1].numpy(), 0.0)  # outputs are NOT zeroed
    # step 2 from a zero carry equals a fresh one-step sequence from zeros
    fresh = list(args)
    fresh[0], fresh[1], fresh[2] = args[0][2:3], np.zeros_like(args[1]), np.zeros((1, B), np.float32)
    o_fresh, _ = _port_fns(kind)[1](*map(torch.tensor, fresh))
    np.testing.assert_allclose(o[2].numpy(), o_fresh[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("kind,tol", [("gru", 1e-3), ("lstm", 2e-3)])
def test_autograd_function_gradients_match_jax(kind, tol):
    T, B, H = 6, 16, 128
    args = _inputs(kind, T, B, H, seed=5)
    diff = [i for i in range(len(args)) if i != 2]
    jax_ref = _jax_fns(kind)[1]

    def jax_loss(*d):
        full = list(map(jnp.asarray, args))
        for i, v in zip(diff, d):
            full[i] = v
        o, s = jax_ref(*full)
        return jnp.sum(o**2) + jnp.sum(s)

    g_jax = jax.grad(jax_loss, argnums=tuple(range(len(diff))))(*[jnp.asarray(args[i]) for i in diff])

    targs = [torch.tensor(a, requires_grad=(i != 2)) for i, a in enumerate(args)]
    o, s = _port_fns(kind)[1](*targs)
    ((o**2).sum() + s.sum()).backward()
    assert targs[2].grad is None  # resets get no gradient
    for i, g in zip(diff, g_jax):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cpu_path_launches_no_kernel(kind):
    cuda_rnn.reset_launch_counts()
    _port_fns(kind)[1](*map(torch.tensor, _inputs(kind, 2, 3, 64)))
    counts = cuda_rnn.launch_counts()
    assert {"gru_seq", "gru_seq_rows", "gru_seq_grid", "lstm_seq", "lstm_seq_rows", "lstm_seq_grid"} <= set(counts)
    assert all(n == 0 for n in counts.values())


@pytest.mark.parametrize(
    "kind,bad",
    [
        ("gru", {"x_proj": (4, 8, 3 * 64 + 1)}),
        ("gru", {"h0": (8, 32)}),
        ("gru", {"resets": (4, 7)}),
        ("gru", {"wh": (64, 3 * 32)}),
        ("lstm", {"hc0": (8, 64)}),
        ("lstm", {"x_proj": (4, 8, 4 * 2048)}),
    ],
)
def test_launch_rejects_shapes_it_does_not_take(kind, bad):
    """The launch checks shapes before it touches the card, so this runs on the CPU."""
    T, B, H = 4, 8, 64
    G = 3 if kind == "gru" else 4
    shapes = {"x_proj": (T, B, G * H), "h0": (B, H), "hc0": (B, 2 * H), "resets": (T, B), "wh": (H, G * H), "bh": (G * H,)}
    shapes.update(bad)
    names = ["x_proj", "h0", "resets", "wh", "bh"] if kind == "gru" else ["x_proj", "hc0", "resets", "wh"]
    args = [torch.zeros(shapes[n]) for n in names]
    launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
    with pytest.raises(ValueError):
        launch(*args)


def test_launch_rejects_other_dtypes():
    T, B, H = 2, 4, 64
    args = [torch.zeros(T, B, 3 * H, dtype=torch.float16), torch.zeros(B, H), torch.zeros(T, B),
            torch.zeros(H, 3 * H, dtype=torch.float16), torch.zeros(3 * H, dtype=torch.float16)]
    with pytest.raises(ValueError):
        cuda_rnn._launch_gru(*args)
