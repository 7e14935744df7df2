"""The port's algorithm math against the JAX package on identical numpy inputs:
categorical distribution, GAE, running mean/std, PPO losses, LR schedules and Adam.
All in float32; the functions are elementwise or short reductions, so they agree to 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo import advantages as jadv
from sample_factory_tpu.algo import losses as jlosses
from sample_factory_tpu.algo import running_mean_std as jrms
from sample_factory_tpu.algo import schedules as jsched
from sample_factory_tpu.algo.distributions import CategoricalDistribution as JaxCategorical
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu_torch.algo import advantages, losses, running_mean_std as rms, schedules
from sample_factory_tpu_torch.algo.distributions import CategoricalDistribution
from sample_factory_tpu_torch.algo.optimizers import make_optimizer, set_lr
from sample_factory_tpu_torch.cfg.arguments import default_cfg

torch.set_num_threads(1)

ATOL = 1e-6


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-6)


def _logits_and_mask(seed, masked):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(4, 5, 6)) * 2).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((4, 5, 6)) < 0.6).astype(np.float32)
        mask[..., 0] = 1.0  # at least one legal action
    return logits, mask


@pytest.mark.parametrize("masked", [False, True])
def test_categorical_matches_jax(masked):
    logits, mask = _logits_and_mask(0, masked)
    other, _ = _logits_and_mask(1, False)
    jd = JaxCategorical(jnp.asarray(logits), None if mask is None else jnp.asarray(mask))
    td = CategoricalDistribution(torch.tensor(logits), None if mask is None else torch.tensor(mask))
    _close(td.probs, jd.probs)
    _close(td.log_probs_tensor, jd.log_probs_tensor, atol=1e-5)  # masked entries are ~-1e9
    _close(td.entropy(), jd.entropy())
    _close(td.symmetric_kl_with_uniform_prior(), jd.symmetric_kl_with_uniform_prior(), atol=1e-4)
    _close(td.kl_divergence(CategoricalDistribution(torch.tensor(other))), jd.kl_divergence(JaxCategorical(jnp.asarray(other))))
    np.testing.assert_array_equal(td.argmax().numpy(), np.asarray(jd.argmax()))

    # sampling: feed the port the JAX draws (jax.random.uniform with minval=1e-20)
    key = jax.random.PRNGKey(3)
    uniform = jax.random.uniform(key, logits.shape, minval=1e-20)
    ja = jd.sample(key)
    ta = td.sample(uniform=torch.tensor(np.asarray(uniform)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32 and ta.shape == (4, 5, 1)
    _close(td.log_prob(ta), jd.log_prob(ja), atol=1e-5)
    if mask is not None:
        assert np.all(np.take_along_axis(mask, ta.numpy().astype(np.int64), -1) == 1.0)


def test_categorical_sample_from_generator_respects_mask():
    logits, mask = _logits_and_mask(2, True)
    td = CategoricalDistribution(torch.tensor(logits), torch.tensor(mask))
    a = td.sample(torch.Generator().manual_seed(0))
    assert np.all(np.take_along_axis(mask, a.numpy().astype(np.int64), -1) == 1.0)


def _gae_inputs(seed):
    rng = np.random.default_rng(seed)
    T, E = 9, 5
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.random((T, E)) < 0.2).astype(np.float32)
    values = rng.normal(size=(T + 1, E)).astype(np.float32)
    valids = (rng.random((T + 1, E)) < 0.8).astype(np.float32)
    return rewards, dones, values, valids


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_jax(seed):
    args = _gae_inputs(seed)
    ref = jadv.gae_advantages(*map(jnp.asarray, args), 0.99, 0.95)
    _close(advantages.gae_advantages(*map(torch.tensor, args), 0.99, 0.95), ref, atol=1e-5)


def test_discounted_sum_matches_jax():
    rewards, dones, _, valids = _gae_inputs(2)
    ref = jadv.discounted_sum(jnp.asarray(rewards), jnp.asarray(dones), jnp.asarray(valids[:-1]), 0.9)
    _close(advantages.discounted_sum(torch.tensor(rewards), torch.tensor(dones), torch.tensor(valids[:-1]), 0.9), ref, atol=1e-5)


def _rms_pair(shape, per_channel=False):
    return jrms.rms_init(shape, per_channel=per_channel), rms.rms_init(shape, per_channel=per_channel)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,per_channel", [((3,), False), ((4, 4, 3), False), ((4, 4, 3), True), ((1,), False)])
def test_rms_update_normalize_denormalize_match_jax(shape, per_channel, masked):
    rng = np.random.default_rng(4)
    js, ts = _rms_pair(shape, per_channel)
    for step in range(3):
        x = (rng.normal(size=(6, 5) + shape) * 3 + 1).astype(np.float32)
        mask = (rng.random((6, 5)) < 0.7).astype(np.float32) if masked else None
        if masked and step == 2:
            mask[:] = 0.0  # an all-masked batch leaves the state unchanged
        js = jrms.rms_update(js, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
        ts = rms.rms_update(ts, torch.tensor(x), None if mask is None else torch.tensor(mask))
        _close(ts.running_mean, js.running_mean, atol=1e-5)
        _close(ts.running_var, js.running_var, atol=1e-4)
        _close(ts.count, js.count)
    _close(rms.rms_normalize(ts, torch.tensor(x)), jrms.rms_normalize(js, jnp.asarray(x)), atol=1e-5)
    _close(rms.rms_denormalize(ts, torch.tensor(x)), jrms.rms_denormalize(js, jnp.asarray(x)), atol=1e-5)


def test_obs_rms_skips_action_mask_and_unlisted_keys():
    from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec

    space = make_dict_spec({"obs": Box((3,)), "extra": Box((2,)), "action_mask": Box((4,))})
    state = rms.obs_rms_init(space, keys_to_normalize=["obs", "action_mask"])
    assert sorted(state) == ["obs"]
    obs = {"obs": torch.ones(2, 3) * 7, "extra": torch.ones(2, 2) * 7}
    out = rms.obs_rms_normalize(state, obs)
    assert torch.equal(out["extra"], obs["extra"]) and not torch.equal(out["obs"], obs["obs"])


def _loss_inputs():
    rng = np.random.default_rng(5)
    n = 32
    return {
        "ratio": np.exp(rng.normal(size=n) * 0.3).astype(np.float32),
        "adv": rng.normal(size=n).astype(np.float32),
        "valids": (rng.random(n) < 0.8).astype(np.float32),
        "new_v": rng.normal(size=n).astype(np.float32),
        "old_v": rng.normal(size=n).astype(np.float32),
        "target": rng.normal(size=n).astype(np.float32),
        "ent": rng.random(n).astype(np.float32),
    }


def test_losses_match_jax():
    d = _loss_inputs()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.tensor(v) for k, v in d.items()}
    for tv, jv in zip(losses.normalize_advantages(t["adv"], t["valids"]), jlosses.normalize_advantages(j["adv"], j["valids"])):
        _close(tv, jv)
    _close(losses.clamp_ratio(t["ratio"] * 30), jlosses.clamp_ratio(j["ratio"] * 30))
    _close(losses.policy_loss(t["ratio"], t["adv"], 1 / 1.1, 1.1, t["valids"]), jlosses.policy_loss(j["ratio"], j["adv"], 1 / 1.1, 1.1, j["valids"]))
    _close(
        losses.value_loss(t["new_v"], t["old_v"], t["target"], 0.2, t["valids"], 0.5),
        jlosses.value_loss(j["new_v"], j["old_v"], j["target"], 0.2, j["valids"], 0.5),
    )
    _close(losses.entropy_exploration_loss(t["ent"], t["valids"], 0.003), jlosses.entropy_exploration_loss(j["ent"], j["valids"], 0.003))
    _close(
        losses.symmetric_kl_exploration_loss(t["ent"] * 100, t["valids"], 0.003),
        jlosses.symmetric_kl_exploration_loss(j["ent"] * 100, j["valids"], 0.003),
    )
    for tv, jv in zip(losses.kl_loss(t["ent"], t["valids"], 0.2), jlosses.kl_loss(j["ent"], j["valids"], 0.2)):
        _close(tv, jv)
    _close(losses.masked_mean(t["adv"], torch.zeros_like(t["valids"])), jlosses.masked_mean(j["adv"], jnp.zeros_like(j["valids"])))


@pytest.mark.parametrize("schedule", ["constant", "kl_adaptive_minibatch", "kl_adaptive_epoch", "linear_decay"])
def test_lr_schedules_match_jax(schedule):
    argv = [f"--lr_schedule={schedule}", "--train_for_env_steps=100000", "--batch_size=1000"]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    lr = 3e-4
    for step, kl in enumerate([0.0001, 0.02, 0.008, 0.1]):
        j_mb = jsched.lr_after_minibatch(jcfg, jnp.float32(lr), jnp.float32(kl), jnp.int32(step))
        t_mb = schedules.lr_after_minibatch(tcfg, lr, torch.tensor(kl), step)
        np.testing.assert_allclose(t_mb, float(j_mb), rtol=1e-6)
        j_ep = jsched.lr_after_epoch(jcfg, jnp.float32(lr), jnp.float32(kl))
        np.testing.assert_allclose(schedules.lr_after_epoch(tcfg, lr, torch.tensor(kl)), float(j_ep), rtol=1e-6)
        lr = t_mb


def test_adam_under_injected_lr_matches_optax():
    """K=5 steps with a different injected learning rate each step."""
    argv = ["--adam_eps=1e-6", "--adam_beta1=0.9", "--adam_beta2=0.999"]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    rng = np.random.default_rng(6)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-3, 1)).astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    lrs = [1e-3, 5e-4, 2e-3, 1e-4, 7e-4]

    tx = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = make_optimizer(tcfg, list(tp.values()))
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        set_lr(opt, lr)
        opt.step()
    for k in p0:
        _close(tp[k], jp[k], atol=1e-6)


@pytest.mark.parametrize("rho_hat,c_hat", [(1.0, 1.0), (0.8, 1.3)])
def test_vtrace_matches_jax(rho_hat, c_hat):
    """Random [R, S] with dones and importance ratios on both sides of the clips: 1e-6."""
    rng = np.random.default_rng(8)
    R, S = 12, 7
    rewards = rng.normal(size=(R, S)).astype(np.float32)
    dones = (rng.random((R, S)) < 0.2).astype(np.float32)
    values = rng.normal(size=(R, S)).astype(np.float32)
    ratios = np.exp(rng.normal(size=(R, S)) * 0.5).astype(np.float32)
    assert (ratios > max(rho_hat, c_hat)).any() and (ratios < min(rho_hat, c_hat)).any() and dones[-1].any()
    jvs, jadv_ = jadv.vtrace(*map(jnp.asarray, (rewards, dones, values, ratios)), 0.99, rho_hat, c_hat)
    tvs, tadv = advantages.vtrace(*map(torch.tensor, (rewards, dones, values, ratios)), 0.99, rho_hat, c_hat)
    _close(tvs, jvs)
    _close(tadv, jadv_)


@pytest.mark.parametrize("lookahead", [False, True], ids=["lamb", "lamb-lookahead"])
def test_lamb_under_injected_lr_matches_optax(lookahead):
    """K=12 updates on identical gradients: with --lamb_lookahead_k=5 the slow weights sync at
    updates 1, 6 and 11 (the count starts at 0). A zero weight vector and a zero gradient
    take the trust-ratio-1 branch. Then the optimizer state goes through its state_dict."""
    argv = ["--optimizer=lamb", f"--lamb_lookahead={lookahead}", "--lamb_lookahead_k=5", "--lamb_lookahead_alpha=0.5"]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    rng = np.random.default_rng(7)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": np.zeros((3,), np.float32), "big": (rng.normal(size=(40,)) * 5).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-3, 1)).astype(np.float32) for k, v in p0.items()} for _ in range(12)]
    grads[0]["b"][:] = 0.0  # zero weights and a zero step: trust 1
    lrs = [1e-3, 5e-4, 2e-3, 1e-4, 7e-4, 1e-3] * 2

    tx = jax_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = make_optimizer(tcfg, list(tp.values()))

    def update(opt, tp, g, lr):
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        set_lr(opt, lr)
        opt.step()

    for step, (g, lr) in enumerate(zip(grads, lrs)):
        if step == 8:
            # a fresh optimizer that loads the state (moments, count, slow weights) goes on alike
            saved = {k: v.detach().clone() for k, v in tp.items()}
            tp2 = {k: torch.nn.Parameter(torch.zeros_like(v)) for k, v in tp.items()}
            opt2 = make_optimizer(tcfg, list(tp2.values()))
            opt2.load_state_dict(opt.state_dict())
            for k in tp2:
                tp2[k].data.copy_(saved[k])
            opt, tp = opt2, tp2
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        update(opt, tp, g, lr)
        for k in p0:
            _close(tp[k], jp[k], atol=1e-6)
    assert opt.param_groups[0]["step"] == 12
    if lookahead:
        slow = state.inner_state[-1].slow
        for k, p in tp.items():
            _close(opt.state[p]["slow"], slow[k], atol=1e-6)
