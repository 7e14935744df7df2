"""The backward of the port's GRU/LSTM sequence ops (ops/cuda_rnn.py) against the JAX package.

On a CUDA tensor the backward is a prologue (the carries entering each step, their projection), the
reverse-time kernel `gru_seq_bwd` / `lstm_seq_bwd` and an epilogue (d_wh, d_bh). Here, on the CPU, the
same prologue and epilogue run around the kernel's plain version (`gru_seq_bwd_reference`,
`lstm_seq_bwd_reference`), and are held against `jax.grad` through JAX's `pallas_gru_seq` and
`pallas_lstm_seq` (the Pallas kernels in interpret mode, their `_bwd` / `_lstm_bwd` the vjp of the scan)
in float32 and bfloat16, and against the port's own CPU backward (`_recompute_grads`, the plain forward
rerun under autograd). The kernels themselves are held against the plain recurrence on the card, in
tests/test_torch_cuda_kernels.py and chip_smoke.py.
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

# jax.grad of the Pallas kernels against the port's new backward: the tolerances of
# tests/test_torch_rnn_kernels.py's gradient test (float32 reassociation drift through the recurrence)
JAX_TOL = {"gru": 1e-3, "lstm": 2e-3}
# the new backward against the port's remat, both float32 on the CPU: they differ only in the order of
# the products' sums (the remat multiplies step by step, the prologue and epilogue over T*B rows)
F32_TOL = 1e-5
# bf16: the remat differentiates under autograd in bf16, rounding every cotangent to bf16 (2^-8
# relative), and the new backward computes them in f32 from the same bf16 gates; measured up to 9.8e-3
# relative to the largest gradient at these shapes; 0.03 is the port's bf16 tolerance of its model tests
BF16_TOL = 0.03
# bf16 against jax.grad of the Pallas kernels, whose `_bwd` / `_lstm_bwd` take the vjp of the bf16 scan and
# so round every cotangent to bf16: the new backward measured up to 1.32e-2 relative to the largest
# gradient over CASES and (32, 16, 256), (16, 8, 512), the port's remat up to 1.73e-2 at the same inputs;
# held at the port's bf16 tolerance
JAX_BF16_TOL = BF16_TOL
BF16_ARGS = (0, 3, 4)  # x_proj, wh, bh are in the compute dtype; the states and resets stay f32

# (name, T, B, H, resets: probability a step resets, or "every" / "none", cotangents: "both", "outs", "final")
CASES = [
    ("base", 6, 16, 128, 0.2, "both"),
    ("t1", 1, 8, 128, 0.2, "both"),
    ("ragged", 4, 5, 100, 0.2, "both"),  # B=5: a ragged row tile; the Pallas kernels tile B by 8, so JAX's scan
    ("reset_every_step", 5, 8, 64, "every", "both"),
    ("reset_none", 5, 8, 64, "none", "both"),
    ("outs_only", 5, 8, 64, 0.2, "outs"),
    ("final_only", 5, 8, 64, 0.2, "final"),
]
CASE_IDS = [c[0] for c in CASES]


def _inputs(kind, T, B, H, resets=0.2, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    state = H if kind == "gru" else 2 * H
    x = rng.normal(size=(T, B, G * H)).astype(np.float32)
    s0 = rng.normal(size=(B, state)).astype(np.float32)
    r = {"every": np.ones((T, B)), "none": np.zeros((T, B))}.get(resets)
    r = (rng.random((T, B)) < resets) if r is None else r
    wh = (rng.normal(size=(H, G * H)) * 0.1).astype(np.float32)
    bh = (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
    args = (x, s0, r.astype(np.float32), wh, bh)
    return args if kind == "gru" else args[:4]


def _cotangents(T, B, H, state, which, seed=1):
    rng = np.random.default_rng(seed)
    d_outs = rng.normal(size=(T, B, H)).astype(np.float32)
    d_state = rng.normal(size=(B, state)).astype(np.float32)
    return d_outs * (which != "final"), d_state * (which != "outs")


def _port_backward(kind, args, d_outs, d_state):
    """The new backward from the saved tensors: forward (the plain version, as on the CPU), then the
    prologue, the recurrence's plain version (in place of the kernel) and the epilogue; the gradients in
    the order of the inputs, resets left out."""
    if kind == "gru":
        outs, _ = cuda_rnn.gru_seq_reference(*args)
        return cuda_rnn.gru_seq_backward(*args, outs, d_outs, d_state, recurrence=cuda_rnn.gru_seq_bwd_reference)
    outs, _ = cuda_rnn.lstm_seq_reference(*args)
    return cuda_rnn.lstm_seq_backward(*args, outs, d_outs, d_state, recurrence=cuda_rnn.lstm_seq_bwd_reference)


def _remat(kind, args, d_outs, d_state):
    reference = cuda_rnn.gru_seq_reference if kind == "gru" else cuda_rnn.lstm_seq_reference
    needs = [i != 2 for i in range(len(args))]
    return [g for g in cuda_rnn._recompute_grads(reference, args, needs, (d_outs, d_state)) if g is not None]


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(np.asarray(g, np.float32) - w).max()) / scale <= tol


def _jax_grads(kind, args, d_outs, d_state, bf16=False):
    """jax.grad through JAX's pallas_gru_seq / pallas_lstm_seq (the scan reference where B is not a multiple of
    8: the Pallas kernels tile B by 8) of sum(outs * d_outs) + sum(state * d_state), every input but resets."""
    jargs = [jnp.asarray(a, jnp.bfloat16) if bf16 and i in BF16_ARGS else jnp.asarray(a) for i, a in enumerate(args)]
    diff = [i for i in range(len(args)) if i != 2]
    jax_fn = {"gru": (pallas_gru_seq, jax_gru_reference), "lstm": (pallas_lstm_seq, jax_lstm_reference)}[kind][args[0].shape[1] % 8 != 0]

    def loss(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        o, s = jax_fn(*full)
        return jnp.sum(o * d_outs) + jnp.sum(s * d_state)

    return jax.grad(loss, argnums=tuple(range(len(diff))))(*[jargs[i] for i in diff])


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("name,T,B,H,resets,which", CASES, ids=CASE_IDS)
def test_backward_matches_jax_grad_of_the_pallas_kernels(kind, name, T, B, H, resets, which):
    args = _inputs(kind, T, B, H, resets, seed=T + B)
    d_outs, d_state = _cotangents(T, B, H, H if kind == "gru" else 2 * H, which)
    g_jax = _jax_grads(kind, args, d_outs, d_state)
    grads = _port_backward(kind, [torch.tensor(a) for a in args], torch.tensor(d_outs), torch.tensor(d_state))
    assert all(g.dtype == torch.float32 for g in grads)
    for g, want in zip(grads, g_jax):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=JAX_TOL[kind], rtol=JAX_TOL[kind])


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("name,T,B,H,resets,which", CASES + [("deep", 32, 16, 256, 0.2, "both")], ids=CASE_IDS + ["deep"])
def test_backward_matches_jax_grad_of_the_pallas_kernels_in_bfloat16(kind, name, T, B, H, resets, which):
    """The compute dtype of the main path's learner: the same prologue, plain recurrence and epilogue in bf16
    against jax.grad in bf16, each gradient in its input's dtype as JAX returns it."""
    args = _inputs(kind, T, B, H, resets, seed=T + B)
    d_outs, d_state = _cotangents(T, B, H, H if kind == "gru" else 2 * H, which)
    g_jax = _jax_grads(kind, args, d_outs, d_state, bf16=True)
    targs = [torch.tensor(a).bfloat16() if i in BF16_ARGS else torch.tensor(a) for i, a in enumerate(args)]
    grads = _port_backward(kind, targs, torch.tensor(d_outs), torch.tensor(d_state))
    assert [str(g.dtype).split(".")[1] for g in grads] == [str(np.asarray(w).dtype) for w in g_jax]
    _assert_close([g.float() for g in grads], [np.asarray(w, np.float32) for w in g_jax], JAX_BF16_TOL)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("name,T,B,H,resets,which", CASES, ids=CASE_IDS)
def test_backward_matches_the_remat_in_float32(kind, name, T, B, H, resets, which):
    args = [torch.tensor(a) for a in _inputs(kind, T, B, H, resets, seed=T + B + 1)]
    d_outs, d_state = map(torch.tensor, _cotangents(T, B, H, args[1].shape[1], which, seed=2))
    _assert_close(_port_backward(kind, args, d_outs, d_state), _remat(kind, args, d_outs, d_state), F32_TOL)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("T,B,H", [(6, 16, 128), (1, 5, 100), (7, 24, 64)])
def test_backward_matches_the_remat_in_bfloat16(kind, T, B, H):
    args = [torch.tensor(a) for a in _inputs(kind, T, B, H, seed=3)]
    for i in BF16_ARGS[: len(args) - 2]:
        args[i] = args[i].bfloat16()
    d_outs, d_state = map(torch.tensor, _cotangents(T, B, H, args[1].shape[1], "both", seed=4))
    grads = _port_backward(kind, args, d_outs, d_state)
    assert [g.dtype for g in grads] == [a.dtype for i, a in enumerate(args) if i != 2]
    _assert_close([g.float() for g in grads], [g.float() for g in _remat(kind, args, d_outs, d_state)], BF16_TOL)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_saturated_gates_give_finite_gradients_and_zero_gate_gradients(kind):
    """Pre-activations below -88 (fault C6): the gates' gradient is 0, as the clamp's backward gives it,
    and every gradient is finite and equal to the remat's."""
    T, B, H = 4, 8, 64
    args = [torch.tensor(a) for a in _inputs(kind, T, B, H, seed=5)]
    sigmoid_gates = [0, 1] if kind == "gru" else [0, 1, 3]  # r, z / i, f, o
    for g in sigmoid_gates:
        args[0][:, :4, g * H:(g + 1) * H] = -200.0
    d_outs, d_state = map(torch.tensor, _cotangents(T, B, H, args[1].shape[1], "both"))
    grads = _port_backward(kind, args, d_outs, d_state)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for g in sigmoid_gates:
        assert bool((grads[0][:, :4, g * H:(g + 1) * H] == 0).all())
    _assert_close(grads, _remat(kind, args, d_outs, d_state), F32_TOL)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_carries_entering_each_step_are_the_forwards(kind):
    """The prologue's h_prev from h0, resets and outs equals the carry the plain forward feeds each step."""
    T, B, H = 5, 8, 32
    args = [torch.tensor(a) for a in _inputs(kind, T, B, H, resets=0.3, seed=6)]
    reference = cuda_rnn.gru_seq_reference if kind == "gru" else cuda_rnn.lstm_seq_reference
    outs, _ = reference(*args)
    state, carries = args[1], []
    for t in range(T):
        carries.append(state[:, :H])
        _, state = reference(args[0][t:t + 1], state, args[2][t:t + 1], *args[3:])
    assert torch.equal(cuda_rnn._carries_in(args[1], args[2], outs), torch.stack(carries))


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_bwd_rows_cover_every_batch_row_once(kind, dtype, sms):
    """The backward's rows a block: a power of two of at most BWD_MAX_ROWS whose blocks cover every batch
    row once (the last block may be partly filled), at least one block an SM where B allows, each block's
    shared memory within the card's limit."""
    spec = cuda_rnn.CardSpec(sms, 13, 0, 232_448)
    itemsize = 2 if dtype == "bfloat16" else 4
    for B in (1, 3, 5, 24, 64, 65, 128, 131, 255, 256, 512, 1024, 2048, 16384):
        for H in (1, 64, 100, 256, 512, 1024):
            rows = cuda_rnn.bwd_rows(kind, B, H, dtype, spec)
            blocks = -(-B // rows)
            assert rows in (1, 2, 4, 8) and rows <= cuda_rnn.BWD_MAX_ROWS
            assert blocks * rows >= B > (blocks - 1) * rows
            assert blocks >= min(B, sms) or cuda_rnn.bwd_smem(kind, H, 2 * rows, itemsize) > spec.smem_limit
            assert cuda_rnn.bwd_smem(kind, H, rows, itemsize) <= spec.smem_limit


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cpu_backward_launches_no_kernel(kind):
    args = [torch.tensor(a).requires_grad_(i != 2) for i, a in enumerate(_inputs(kind, 3, 5, 32, seed=7))]
    fn = cuda_rnn.gru_seq if kind == "gru" else cuda_rnn.lstm_seq
    cuda_rnn.reset_launch_counts()
    out, state = fn(*args)
    ((out**2).sum() + state.sum()).backward()
    counts = cuda_rnn.launch_counts()
    assert {"gru_seq_bwd", "lstm_seq_bwd"} <= set(counts) and all(n == 0 for n in counts.values())
    assert args[2].grad is None and all(a.grad is not None for i, a in enumerate(args) if i != 2)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_an_in_place_write_to_the_outputs_is_caught(kind):
    """The backward reads the forward's saved outputs: a later in-place write to them raises in backward
    rather than giving wrong gradients."""
    args = [torch.tensor(a).requires_grad_(i != 2) for i, a in enumerate(_inputs(kind, 3, 5, 32, seed=8))]
    out, _ = (cuda_rnn.gru_seq if kind == "gru" else cuda_rnn.lstm_seq)(*args)
    loss = out.sum()
    out.mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()
