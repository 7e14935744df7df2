"""The port's continuous and tuple action distributions against the JAX package's on
identical numpy inputs: log_prob, entropy, KL, symmetric KL and argmax to 1e-6 (elementwise
float32 math). Samples are drawn from the port's own generator and compared by their
moments, within 4 standard errors, never by matched seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sample_factory_tpu.algo import distributions as jdist
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, TupleSpec as JTupleSpec
from sample_factory_tpu_torch.algo import distributions as tdist
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, TupleSpec, action_dtype, num_action_parameters, num_actions

torch.set_num_threads(1)

ATOL = 1e-6


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-6)


def _gauss_params(seed, d=3, extreme=False):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(4, 5, d)).astype(np.float32)
    log_std = (rng.normal(size=(4, 5, d)) * 0.5).astype(np.float32)
    if extreme:
        log_std[0, 0, 0], log_std[0, 1, 0] = -20.0, 20.0  # beyond the stddev clip on both sides
    return np.concatenate([means, log_std], axis=-1)


def test_continuous_matches_jax():
    params, other = _gauss_params(0, extreme=True), _gauss_params(1)
    actions = np.random.default_rng(2).normal(size=(4, 5, 3)).astype(np.float32)
    jd, td = jdist.ContinuousDistribution(jnp.asarray(params)), tdist.ContinuousDistribution(torch.tensor(params))
    assert float(td.stddevs.min()) == pytest.approx(1e-4) and float(td.stddevs.max()) == pytest.approx(1e4)
    _close(td.stddevs, jd.stddevs)
    # log_prob divides by the variance: relative 1e-6 where the stddev sits at its lower clip
    np.testing.assert_allclose(td.log_prob(torch.tensor(actions)).numpy(), np.asarray(jd.log_prob(jnp.asarray(actions))), rtol=1e-6, atol=ATOL)
    _close(td.entropy(), jd.entropy())
    _close(td.symmetric_kl_with_uniform_prior(), jd.symmetric_kl_with_uniform_prior())
    np.testing.assert_allclose(
        td.kl_divergence(tdist.ContinuousDistribution(torch.tensor(other))).numpy(),
        np.asarray(jd.kl_divergence(jdist.ContinuousDistribution(jnp.asarray(other)))), rtol=1e-6, atol=ATOL,
    )
    np.testing.assert_array_equal(tdist.argmax_actions(td).numpy(), np.asarray(jdist.argmax_actions(jd)))
    assert isinstance(tdist.get_action_distribution(Box((3,)), torch.tensor(params)), tdist.ContinuousDistribution)


def test_continuous_sample_moments():
    params = torch.tensor([[0.5, -1.0, np.log(0.3), np.log(2.0)]], dtype=torch.float32).expand(20000, 4)
    td = tdist.ContinuousDistribution(params)
    gen = torch.Generator().manual_seed(0)
    a, lp = tdist.sample_actions_log_probs(td, gen)
    assert a.shape == (20000, 2) and a.dtype == torch.float32
    n = a.shape[0]
    for dim, (mean, std) in enumerate([(0.5, 0.3), (-1.0, 2.0)]):
        x = a[:, dim].double()
        assert abs(float(x.mean()) - mean) < 4 * std / np.sqrt(n)
        assert abs(float(x.var()) - std**2) < 4 * std**2 * np.sqrt(2.0 / n)  # se of a normal's sample variance
    _close(lp, jdist.ContinuousDistribution(jnp.asarray(params.numpy())).log_prob(jnp.asarray(a.numpy())), atol=1e-5)
    # the same generator state gives the same draw; the next draw differs
    b = td.sample(torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, td.sample(gen))


SPACES = (Discrete(3), Box((2,)), Discrete(4))
JSPACES = (JDiscrete(3), JBox((2,)), JDiscrete(4))


def _tuple_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = np.concatenate([rng.normal(size=(6, 3)), _gauss_params(seed, d=2)[0, :1].repeat(6, 0) + rng.normal(size=(6, 4)) * 0.1, rng.normal(size=(6, 4))], -1)
    actions = np.concatenate([rng.integers(0, 3, (6, 1)), rng.normal(size=(6, 2)), rng.integers(0, 4, (6, 1))], -1)
    return logits.astype(np.float32), actions.astype(np.float32)


def test_tuple_matches_jax():
    space, jspace = TupleSpec(SPACES), JTupleSpec(JSPACES)
    assert num_action_parameters(space) == 11 and num_actions(space) == 4 and action_dtype(space) == "float32"
    assert action_dtype(TupleSpec((Discrete(2), Discrete(3)))) == "int32"
    logits, actions = _tuple_inputs(3)
    other, _ = _tuple_inputs(4)
    jd = jdist.get_action_distribution(jspace, jnp.asarray(logits))
    td = tdist.get_action_distribution(space, torch.tensor(logits))
    assert isinstance(td, tdist.TupleDistribution)
    _close(td.log_prob(torch.tensor(actions)), jd.log_prob(jnp.asarray(actions)))
    _close(td.entropy(), jd.entropy())
    _close(td.symmetric_kl_with_uniform_prior(), jd.symmetric_kl_with_uniform_prior())
    _close(td.kl_divergence(tdist.get_action_distribution(space, torch.tensor(other))),
           jd.kl_divergence(jdist.get_action_distribution(jspace, jnp.asarray(other))))
    targmax = td.argmax()
    assert targmax.dtype == torch.float32 and targmax.shape == (6, 4)
    np.testing.assert_array_equal(targmax.numpy(), np.asarray(jd.argmax()))
    with pytest.raises(AssertionError, match="expected 11 action params"):
        tdist.get_action_distribution(space, torch.tensor(logits[:, :10]))


def test_tuple_per_part_masks_and_sample_moments():
    space = TupleSpec((Discrete(3), Box((1,))))
    n = 20000
    logits = torch.tensor([[0.2, 1.0, -0.5, 0.7, np.log(0.5)]], dtype=torch.float32).expand(n, 5)
    mask = [torch.tensor([[1.0, 0.0, 1.0]]).expand(n, 3), None]  # the likeliest category is illegal
    td = tdist.get_action_distribution(space, logits, mask)
    jd = jdist.get_action_distribution(JTupleSpec((JDiscrete(3), JBox((1,)))), jnp.asarray(logits.numpy()),
                                       [jnp.asarray(mask[0].numpy()), None])
    a, lp = tdist.sample_actions_log_probs(td, torch.Generator().manual_seed(1))
    assert a.shape == (n, 2) and a.dtype == torch.float32
    assert not (a[:, 0] == 1).any()
    p = np.asarray(jd.distributions[0].probs)[0]
    for cat in (0, 2):
        freq = float((a[:, 0] == cat).double().mean())
        assert abs(freq - p[cat]) < 4 * np.sqrt(p[cat] * (1 - p[cat]) / n)
    assert abs(float(a[:, 1].double().mean()) - 0.7) < 4 * 0.5 / np.sqrt(n)
    _close(lp, jd.log_prob(jnp.asarray(a.numpy())), atol=1e-5)
    _close(td.entropy(), jd.entropy())
