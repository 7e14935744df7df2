"""`lstm_seq_in` (ops/cuda_rnn.py), the LSTM from its raw input, against the JAX package.

`FusedLSTMCell(seq=True)` hands its input product and its recurrence to `lstm_seq_in` as one function; on the card, where
the plan allows (DMLab's instruction encoder), that is one launch of `lstm_seq_resident_in` forward and one of
`lstm_seq_resident_in_bwd` backward, on the buffers the forward saved, plus two products. Here, on the CPU, lstm_seq_in is
its plain version (x @ wi + bi, then the plain recurrence) with the plain forward rerun under autograd for its gradient; it
is held against the JAX package's `FusedLSTMCell(seq=True)` (`sample_factory_tpu/ops/rnn_cells.py`: the scan on the CPU) and
`jax.grad` of it, with the parameters carried across by `bridge.py`, and against `pallas_lstm_seq` run in interpret mode
where its tiles allow. The backward's assembly from the kernel's saved buffers (one product for d_wi, d_wh and d_bi) runs on
CPU stand-ins of those buffers against autograd of the plain version. The kernels are held against these plain versions on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.ops.pallas_gru import pallas_lstm_seq
from sample_factory_tpu.ops.rnn_cells import FusedLSTMCell as JaxFusedLSTMCell
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.ops import cuda_rnn, rnn_cells
from sample_factory_tpu_torch.ops.rnn_cells import FusedLSTMCell

torch.set_num_threads(1)

# float32: the two sides may sum the products in other orders (reassociation drift through 16 steps; equal here); bf16: both
# round every gate op to bf16 and XLA may keep some intermediates in f32, so single values can land a bf16 ulp apart and the
# flip feeds forward, 0.03 being the port's bf16 tolerance of its model tests. Gradients relative to the largest of each.
TOL = {"float32": 1e-5, "bfloat16": 0.03}
# In bf16 JAX's gradient of bi, a sum over T*B rows of bf16 cotangents, strays from the float64 value by up to 0.040 relative
# (the dmlab case; the port's by 0.0077): a bf16 gradient farther than TOL from JAX's passes where it is within TOL of the
# float64 value and nearer it than JAX's.
# (name, T, B, I, H, reset probability): DMLab's instruction encoder (16 tokens of a 20-wide embedding into an LSTM-64) at a
# small batch, a narrow cell, one step, and rows reset at every step
CASES = [("dmlab", 16, 6, 20, 64, 0.2), ("h16", 7, 5, 20, 16, 0.3), ("t1", 1, 4, 20, 64, 0.2), ("every", 5, 3, 12, 16, 1.0)]
CASE_IDS = [c[0] for c in CASES]


def _params(I, H, seed):
    rng = np.random.default_rng(seed)
    return {"params": {"wi": (rng.normal(size=(I, 4 * H)) / np.sqrt(I)).astype(np.float32),
                       "wh": (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
                       "bi": (rng.normal(size=(4 * H,)) * 0.1).astype(np.float32)}}


def _inputs(T, B, I, H, resets, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, I)).astype(np.float32)
    hc0 = rng.normal(size=(B, 2 * H)).astype(np.float32) * 0.5
    r = (rng.random((T, B)) < resets).astype(np.float32)
    d_outs = rng.normal(size=(T, B, H)).astype(np.float32)
    d_state = rng.normal(size=(B, 2 * H)).astype(np.float32)
    return x, hc0, r, d_outs, d_state


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _jax_cell(H, dtype, params, x, hc0, resets, d_outs, d_state):
    """JAX's FusedLSTMCell(seq=True): outs, hc_final, and jax.grad of <outs, d_outs> + <hc_final, d_state> into x, wi, bi,
    wh and hc0."""
    cell = JaxFusedLSTMCell(features=H, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)

    def loss(p, x, hc0):
        outs, hc = cell.apply(p, x, hc0, jnp.asarray(resets), seq=True)
        return jnp.sum(outs * d_outs) + jnp.sum(hc * d_state), (outs, hc)

    (_, (outs, hc)), (g_p, g_x, g_hc0) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(hc0))
    g = g_p["params"]
    return outs, hc, (g_x, g["wi"], g["bi"], g["wh"], g_hc0)


def _port_cell(I, H, dtype, params, x, hc0, resets, d_outs, d_state):
    """The port's FusedLSTMCell(seq=True) on the bridged parameters: outs, hc_final and autograd's gradients of the same loss."""
    cell = bridge.load_flax_params(FusedLSTMCell(I, H, dtype=getattr(torch, dtype)), params)
    xt, hc0t = torch.tensor(x, requires_grad=True), torch.tensor(hc0, requires_grad=True)
    outs, hc = cell(xt, hc0t, resets=torch.tensor(resets), seq=True)
    grads = torch.autograd.grad((outs * torch.tensor(d_outs)).sum() + (hc * torch.tensor(d_state)).sum(),
                                (xt, cell.wi, cell.bi, cell.wh, hc0t))
    return outs.detach(), hc.detach(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,T,B,I,H,resets", CASES, ids=CASE_IDS)
def test_lstm_seq_in_matches_jax_fused_lstm_cell(name, T, B, I, H, resets, dtype):
    """FusedLSTMCell(seq=True) through lstm_seq_in on the CPU against JAX's FusedLSTMCell(seq=True) on the same parameters
    (bridge.py) and inputs: the outputs, the final state and the gradients of x, wi, bi, wh and hc0, each gradient in its
    leaf's dtype, within TOL of the largest."""
    params = _params(I, H, seed=T + B + H)
    x, hc0, r, d_outs, d_state = _inputs(T, B, I, H, resets, seed=T * B)
    j_outs, j_hc, j_grads = _jax_cell(H, dtype, params, x, hc0, r, d_outs, d_state)
    t_outs, t_hc, t_grads = _port_cell(I, H, dtype, params, x, hc0, r, d_outs, d_state)
    tol = TOL[dtype]
    np.testing.assert_allclose(t_outs.numpy(), np.asarray(j_outs, np.float32), atol=tol, rtol=0)
    np.testing.assert_allclose(t_hc.numpy(), np.asarray(j_hc, np.float32), atol=tol, rtol=0)
    exact = _float64_grads(params, x, hc0, r, d_outs, d_state) if dtype == "bfloat16" else None
    for k, (leaf, got, want) in enumerate(zip(("x", "wi", "bi", "wh", "hc0"), t_grads, j_grads)):
        assert tuple(got.shape) == tuple(want.shape), leaf
        err = _rel(got.float().numpy(), want)
        if err > tol and exact is not None:
            err = _rel(got.float().numpy(), exact[k])
            assert err <= min(tol, _rel(np.asarray(want, np.float32), exact[k])), (leaf, err)
        assert err <= tol, (leaf, err)


def _float64_grads(params, x, hc0, resets, d_outs, d_state):
    """The gradients of x, wi, bi, wh and hc0 of the plain version in float64."""
    p = params["params"]
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, p["wi"], p["bi"], p["wh"], hc0)]
    x64, wi, bi, wh, hc = leaves
    outs, state = cuda_rnn.lstm_seq_in_reference(x64, wi, bi, hc, torch.tensor(resets, dtype=torch.float64), wh)
    loss = (outs * torch.tensor(d_outs, dtype=torch.float64)).sum() + (state * torch.tensor(d_state, dtype=torch.float64)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_seq_in_matches_the_pallas_kernel_in_interpret_mode(dtype):
    """At a width the Pallas LSTM tiles (H=128, B a multiple of the sublane tile), lstm_seq_in against JAX's input product
    and `pallas_lstm_seq` run in interpret mode, forward and jax.grad through its custom_vjp."""
    T, B, I, H = 4, 16, 20, 128
    params = _params(I, H, seed=3)["params"]
    x, hc0, r, d_outs, d_state = _inputs(T, B, I, H, 0.25, seed=4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(wi, bi, wh, x, hc0):
        outs, hc = pallas_lstm_seq(x.astype(jdt) @ wi.astype(jdt) + bi.astype(jdt), hc0, jnp.asarray(r), wh.astype(jdt))
        return jnp.sum(outs * d_outs) + jnp.sum(hc * d_state), (outs, hc)

    (_, (j_outs, j_hc)), j_grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (params["wi"], params["bi"], params["wh"], x, hc0)))
    dt = getattr(torch, dtype)
    wi, bi, wh, xt, hc0t = (torch.tensor(a, requires_grad=True) for a in (params["wi"], params["bi"], params["wh"], x, hc0))
    outs, hc = cuda_rnn.lstm_seq_in(xt.to(dt), wi.to(dt), bi.to(dt), hc0t, torch.tensor(r), wh.to(dt))
    t_grads = torch.autograd.grad((outs * torch.tensor(d_outs)).sum() + (hc * torch.tensor(d_state)).sum(), (wi, bi, wh, xt, hc0t))
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-4  # the Pallas kernel's tile order of the products (tests/test_torch_rnn_kernels.py)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(j_outs, np.float32), atol=tol, rtol=0)
    np.testing.assert_allclose(hc.detach().numpy(), np.asarray(j_hc, np.float32), atol=tol, rtol=0)
    for got, want in zip(t_grads, j_grads):
        assert _rel(got.numpy(), want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,T,B,I,H,resets", CASES, ids=CASE_IDS)
def test_backward_assembly_from_the_saved_buffers(name, T, B, I, H, resets, dtype):
    """The fused kernel's backward as `lstm_seq_in_backward` assembles it, on CPU stand-ins of the buffers the kernel saves
    (lstm_seq_in_saved_reference: proj, the cell states, xh = [x | the carry entering each step | 1 | 0 ...]) and the plain
    recurrence on the saved cell states: d_x, and d_wi, d_bi and d_wh out of the one product xh^T @ d_proj, against autograd
    of the plain version; xh laid out as the kernel writes it."""
    params = _params(I, H, seed=T + B + H + 1)["params"]
    x, hc0, r, d_outs, d_state = _inputs(T, B, I, H, resets, seed=T * B + 1)
    dt = getattr(torch, dtype)
    leaves = [torch.tensor(a).to(dt).requires_grad_() for a in (x, params["wi"], params["bi"])]
    hc0t = torch.tensor(hc0, requires_grad=True)
    wh = torch.tensor(params["wh"]).to(dt).requires_grad_()
    args = (*leaves, hc0t, torch.tensor(r), wh)
    outs, hc = cuda_rnn.lstm_seq_in_reference(*args)
    want = torch.autograd.grad((outs * torch.tensor(d_outs)).sum() + (hc * torch.tensor(d_state)).sum(), (*leaves, wh, hc0t))
    with torch.no_grad():
        s_outs, s_hc, proj, cells, xh = cuda_rnn.lstm_seq_in_saved_reference(*args)
        assert torch.equal(s_outs, outs) and torch.equal(s_hc, hc)
        K = cuda_rnn.in_width(I, H)
        assert xh.shape == (T, B, K) and xh.dtype == dt and K % 8 == 0 and K >= I + H + 1
        assert torch.equal(xh[..., :I], args[0]) and bool((xh[..., I + H] == 1).all()) and bool((xh[..., I + H + 1:] == 0).all())
        assert torch.equal(xh[0, :, I:I + H], hc0t[:, :H].to(dt))
        got = cuda_rnn.lstm_seq_in_backward(args[1], hc0t, args[4], wh, proj, cells, xh, torch.tensor(d_outs), torch.tensor(d_state),
                                            recurrence=cuda_rnn.lstm_seq_bwd_reference)
    tol = TOL[dtype]
    for leaf, g, w in zip(("x", "wi", "bi", "wh", "hc0"), got, want):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), leaf
        assert _rel(g.float().numpy(), w.float().numpy()) <= tol, (leaf, _rel(g.float().numpy(), w.float().numpy()))


def test_saved_cells_are_what_the_backward_recomputes():
    """The plain recurrence on the saved cell states equals the plain recurrence that recomputes them (the unfused route's
    backward), bit for bit in float32: the fused kernel's saved states stand in for the pass it skips."""
    T, B, I, H = 6, 5, 20, 16
    params = _params(I, H, seed=9)["params"]
    x, hc0, r, d_outs, d_state = (torch.tensor(a) for a in _inputs(T, B, I, H, 0.3, seed=10))
    _, _, proj, cells, _ = cuda_rnn.lstm_seq_in_saved_reference(x, torch.tensor(params["wi"]), torch.tensor(params["bi"]), hc0, r,
                                                                torch.tensor(params["wh"]))
    wh = torch.tensor(params["wh"])
    given = cuda_rnn.lstm_seq_bwd_reference(d_outs, d_state, r, proj, hc0, wh, cells)
    recomputed = cuda_rnn.lstm_seq_bwd_reference(d_outs, d_state, r, proj, hc0, wh)
    assert all(torch.equal(a, b) for a, b in zip(given, recomputed))
    zero = cuda_rnn.lstm_seq_bwd_reference(d_outs, None, r, proj, hc0, wh, cells)
    zeros = cuda_rnn.lstm_seq_bwd_reference(d_outs, torch.zeros_like(d_state), r, proj, hc0, wh)
    assert all(torch.equal(a, b) for a, b in zip(zero, zeros))


def test_the_cell_takes_lstm_seq_in_without_a_model_axis_and_lstm_seq_with_one(monkeypatch):
    """FusedLSTMCell(seq=True) hands x, wi, bi, hc, resets and wh to lstm_seq_in; under tensor parallelism (a model axis: x_proj
    gathered from the ranks' gate columns) it keeps the Linear and lstm_seq."""
    calls = []
    monkeypatch.setattr(rnn_cells, "lstm_seq_in", lambda *args: calls.append(("lstm_seq_in", args)) or ("in", None))
    monkeypatch.setattr(rnn_cells, "lstm_seq", lambda *args: calls.append(("lstm_seq", args)) or ("seq", None))
    cell = bridge.load_flax_params(FusedLSTMCell(20, 16), _params(20, 16, seed=5))
    x, hc0, r, _, _ = (torch.tensor(a) for a in _inputs(4, 3, 20, 16, 0.2, seed=6))
    assert cell(x, hc0, resets=r, seq=True)[0] == "in"
    (name, (xa, wi, bi, hc, resets, wh)), = calls
    assert name == "lstm_seq_in" and torch.equal(xa, x) and wi is cell.wi and bi is cell.bi and wh is cell.wh
    assert torch.equal(hc, hc0) and torch.equal(resets, r)
    calls.clear()
    monkeypatch.setattr(rnn_cells, "copy_to_model", lambda t, axis: t)
    monkeypatch.setattr(rnn_cells, "gather_from_model", lambda t, dim, axis: t)
    cell.model_axis = "model"
    assert cell(x, hc0, resets=r, seq=True)[0] == "seq"
    (name, (x_proj, *_)), = calls
    assert name == "lstm_seq" and torch.allclose(x_proj, x @ cell.wi + cell.bi)


def test_no_buffers_are_saved_without_a_gradient():
    """Under no_grad (the rollout, the last value) lstm_seq_in's outputs carry no graph; with a gradient they do, and the
    CPU's backward reruns the plain version."""
    T, B, I, H = 3, 4, 20, 16
    params = _params(I, H, seed=7)["params"]
    x, hc0, r, _, _ = (torch.tensor(a) for a in _inputs(T, B, I, H, 0.2, seed=8))
    wi = torch.tensor(params["wi"], requires_grad=True)
    with torch.no_grad():
        outs, hc = cuda_rnn.lstm_seq_in(x, wi, torch.tensor(params["bi"]), hc0, r, torch.tensor(params["wh"]))
    assert outs.grad_fn is None and hc.grad_fn is None
    outs, hc = cuda_rnn.lstm_seq_in(x, wi, torch.tensor(params["bi"]), hc0, r, torch.tensor(params["wh"]))
    assert type(outs.grad_fn).__name__ == "LSTMSeqInFunctionBackward"
    (g,) = torch.autograd.grad(outs.sum(), (wi,))
    ref_outs, _ = cuda_rnn.lstm_seq_in_reference(x, wi, torch.tensor(params["bi"]), hc0, r, torch.tensor(params["wh"]))
    (ref,) = torch.autograd.grad(ref_outs.sum(), (wi,))
    assert torch.equal(g, ref)
