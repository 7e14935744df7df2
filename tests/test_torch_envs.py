"""The port's batched synthetic, classic-control and ant envs against `jax.vmap` of the
JAX envs.

The JAX envs' random draws are computed from the same keys as
`sample_factory_tpu/envs/device_env.py` splits them (vector_reset; vector_step ->
autoreset_step -> env.step/env.reset) and fed to the port, so the two step one to one.
Synthetic envs: exact equality. CartPole and Pendulum: flags, counters and rewards of
CartPole exact; float states to 1e-6 (XLA and torch evaluate sin/cos and fuse the
arithmetic differently, one float32 ulp a step). Ant: see its test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.envs.builtin import ant as jant
from sample_factory_tpu.envs.builtin import classic_control as jcc
from sample_factory_tpu.envs.builtin import synthetic as jsyn
from sample_factory_tpu.envs.device_env import vector_reset, vector_step
from sample_factory_tpu_torch.envs.builtin import ant, classic_control, synthetic
from sample_factory_tpu_torch.envs.device_env import autoreset_step
from sample_factory_tpu_torch.envs.discretized import Discretized
from sample_factory_tpu_torch.envs.spaces import Discrete, num_action_parameters

torch.set_num_threads(1)

N = 12


def _t(x):
    return torch.tensor(np.asarray(x))


def _synthetic_draws(jenv, keys):
    """What jenv._obs(key) draws, for a batch of per-env keys."""
    if isinstance(jenv, jsyn.SyntheticMaskedEnv):
        def one(k):
            k1, k2 = jax.random.split(k)
            return jax.random.uniform(k1, (jenv.dim,)), jax.random.bernoulli(k2, 0.5)

        obs, top = jax.vmap(one)(keys)
        return {"obs": _t(obs), "top_masked": _t(top)}
    shape = jenv.obs_space["obs"].shape
    return {"obs": _t(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))}


def _cartpole_draws(jenv, keys):
    return {"s": _t(jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=-0.05, maxval=0.05))(keys))}


def _pendulum_draws(jenv, keys):
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (), minval=-np.pi, maxval=np.pi), jax.random.uniform(k2, (), minval=-1.0, maxval=1.0)

    th, thdot = jax.vmap(one)(keys)
    return {"th": _t(th), "thdot": _t(thdot)}


def _ant_draws(jenv, keys):
    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (9, 3), minval=-0.01, maxval=0.01), jax.random.uniform(k2, (9, 3), minval=-0.05, maxval=0.05))

    pos, vel = jax.vmap(one)(keys)
    return {"pos": _t(pos), "vel": _t(vel)}


def _split_step_keys(key, num_envs):
    step_keys, reset_keys = jax.vmap(lambda k: tuple(jax.random.split(k)))(jax.random.split(key, num_envs))
    return step_keys, reset_keys


def _actions(space_kind, rng, n):
    if space_kind == "discrete10":
        return rng.integers(0, 10, size=(n, 1)).astype(np.int32)
    if space_kind == "discrete6":
        return rng.integers(0, 6, size=(n, 1)).astype(np.int32)
    if space_kind == "box2":
        return rng.normal(size=(n, 2)).astype(np.float32)
    return np.concatenate([rng.integers(0, 3, size=(n, 1)), rng.normal(size=(n, 2))], -1).astype(np.float32)  # tuple


SYNTHETIC = [
    pytest.param("synthetic_discrete", "discrete10", id="discrete"),
    pytest.param("synthetic_vector_discrete", "discrete10", id="vector_discrete"),
    pytest.param("synthetic_continuous", "box2", id="continuous"),
    pytest.param("synthetic_tuple", "tuple", id="tuple"),
    pytest.param("synthetic_masked", "discrete6", id="masked"),
]


@pytest.mark.parametrize("name,kind", SYNTHETIC)
def test_synthetic_env_steps_match_jax(name, kind):
    class Cfg:
        custom_env_num_actions = 10
        custom_env_episode_len = 5  # terminations and auto-resets within 12 steps

    jenv, tenv = jsyn.make_synthetic_env(name, Cfg()), synthetic.make_synthetic_env(name, Cfg())
    assert tenv.obs_space.keys() == jenv.obs_space.keys()
    assert num_action_parameters(tenv.action_space) == {"discrete10": 10, "discrete6": 6, "box2": 4, "tuple": 7}[kind]
    key = jax.random.PRNGKey(5)
    key, reset_key = jax.random.split(key)
    jobs, jstate = vector_reset(jenv, reset_key, N)
    tobs, tstate = tenv.reset(N, "cpu", draws=_synthetic_draws(jenv, jax.random.split(reset_key, N)))
    rng = np.random.default_rng(0)
    dones_seen = 0
    for _ in range(12):
        for k in jobs:
            np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]), err_msg=k)
        actions = _actions(kind, rng, N)
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, jinfo = vector_step(jenv, k, jstate, jnp.asarray(actions))
        step_keys, reset_keys = _split_step_keys(k, N)
        tobs, tstate, trew, tdone, tinfo = autoreset_step(
            tenv, tstate, torch.tensor(actions), step_draws=_synthetic_draws(jenv, step_keys), reset_draws=_synthetic_draws(jenv, reset_keys)
        )
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tstate["steps"].numpy(), np.asarray(jstate["steps"]))
        np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
        assert trew.dtype == torch.float32
        dones_seen += int(tdone.sum())
    assert dones_seen == 2 * N
    if name == "synthetic_masked":
        assert 0 < float(tobs["action_mask"][:, -1].sum()) < N and bool((tobs["action_mask"][:, :-1] == 1).all())


def test_synthetic_envs_draw_from_the_generator():
    for name in synthetic.ENV_NAMES:
        env = synthetic.make_synthetic_env(name)
        runs = []
        for _ in range(2):
            gen = torch.Generator().manual_seed(3)
            obs, state = env.reset(4, "cpu", generator=gen)
            a = torch.zeros((4, 3)) if name in ("synthetic_continuous", "synthetic_tuple") else torch.zeros((4, 1), dtype=torch.int32)
            obs, state, rew, done, info = autoreset_step(env, state, a[:, :2] if name == "synthetic_continuous" else a, generator=gen)
            runs.append(obs["obs"])
        assert torch.equal(*runs) and runs[0].dtype == torch.float32
    with pytest.raises(ValueError, match="Unknown synthetic env"):
        synthetic.make_synthetic_env("synthetic_multi_agent")


def test_cartpole_steps_match_jax():
    jenv, tenv = jcc.CartPoleEnv(), classic_control.CartPoleEnv()
    key = jax.random.PRNGKey(2)
    key, reset_key = jax.random.split(key)
    jobs, jstate = vector_reset(jenv, reset_key, N)
    tobs, tstate = tenv.reset(N, "cpu", draws=_cartpole_draws(jenv, jax.random.split(reset_key, N)))
    np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]))
    rng = np.random.default_rng(1)
    terminated = 0
    for _ in range(60):  # always pushing right: the poles fall within ~10 steps, then reset
        actions = np.where(rng.random((N, 1)) < 0.9, 1, 0).astype(np.int32)
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, jinfo = vector_step(jenv, k, jstate, jnp.asarray(actions))
        _, reset_keys = _split_step_keys(k, N)
        tobs, tstate, trew, tdone, tinfo = autoreset_step(tenv, tstate, torch.tensor(actions), reset_draws=_cartpole_draws(jenv, reset_keys))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo["terminated"].numpy(), np.asarray(jinfo["terminated"]))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tstate["steps"].numpy(), np.asarray(jstate["steps"]))
        np.testing.assert_allclose(tobs["obs"].numpy(), np.asarray(jobs["obs"]), atol=1e-6, rtol=1e-6)
        # carry the JAX state on, so that one-ulp differences do not add up over the run
        tstate = {"s": _t(jstate["s"]), "steps": _t(jstate["steps"])}
        terminated += int(tinfo["terminated"].sum())
    assert terminated >= N


def test_pendulum_steps_match_jax():
    jenv, tenv = jcc.PendulumEnv(), classic_control.PendulumEnv()
    key = jax.random.PRNGKey(4)
    key, reset_key = jax.random.split(key)
    jobs, jstate = vector_reset(jenv, reset_key, N)
    tobs, tstate = tenv.reset(N, "cpu", draws=_pendulum_draws(jenv, jax.random.split(reset_key, N)))
    np.testing.assert_allclose(tobs["obs"].numpy(), np.asarray(jobs["obs"]), atol=1e-6)
    # start near the time limit: the truncation and the auto-reset happen within the run
    jstate["steps"] = jstate["steps"] + 195
    tstate["steps"] = tstate["steps"] + 195
    rng = np.random.default_rng(2)
    truncated = 0
    for _ in range(10):
        actions = (rng.normal(size=(N, 1)) * 2).astype(np.float32)  # some beyond the +-2 torque clip
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, jinfo = vector_step(jenv, k, jstate, jnp.asarray(actions))
        _, reset_keys = _split_step_keys(k, N)
        tobs, tstate, trew, tdone, tinfo = autoreset_step(tenv, tstate, torch.tensor(actions), reset_draws=_pendulum_draws(jenv, reset_keys))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(tobs["obs"].numpy(), np.asarray(jobs["obs"]), atol=1e-6, rtol=1e-6)
        for name in ("th", "thdot"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), atol=1e-6, rtol=1e-6)
        tstate = {k_: _t(v) for k_, v in jstate.items()}
        truncated += int(tinfo["time_outs"].sum())
    assert truncated == N


def test_ant_geometry_matches_jax():
    jgeo, tgeo = jant._build_geometry(), ant._build_geometry()
    assert set(jgeo) == set(tgeo)
    for name, value in jgeo.items():
        np.testing.assert_array_equal(tgeo[name], value, err_msg=name)


def test_ant_control_steps_match_jax():
    """8 control steps (128 substeps of float32 penalty physics with spring constants up to
    4000) from the same reset state under the same actions: positions, quaternions,
    velocities, observations and rewards within 1e-4. The two sides sum the per-body
    forces in other orders, and the stiff springs pass those last-bit differences on."""
    n = 6
    jenv, tenv = jant.AntEnv(episode_len=150), ant.AntEnv(episode_len=150)
    key = jax.random.PRNGKey(0)
    key, reset_key = jax.random.split(key)
    jobs, jstate = vector_reset(jenv, reset_key, n)
    tobs, tstate = tenv.reset(n, "cpu", draws=_ant_draws(jenv, jax.random.split(reset_key, n)))
    assert tobs["obs"].shape == (n, 59) and tobs["obs"].dtype == torch.float32
    np.testing.assert_allclose(tobs["obs"].numpy(), np.asarray(jobs["obs"]), atol=1e-6)
    rng = np.random.default_rng(3)
    jstep = jax.jit(lambda k, s, a: vector_step(jenv, k, s, a))
    for _ in range(8):
        actions = rng.uniform(-1.3, 1.3, size=(n, 8)).astype(np.float32)  # some beyond the clip
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, _ = jstep(k, jstate, jnp.asarray(actions))
        _, reset_keys = _split_step_keys(k, n)
        tobs, tstate, trew, tdone, _ = autoreset_step(tenv, tstate, torch.tensor(actions), reset_draws=_ant_draws(jenv, reset_keys))
        assert not bool(tdone.any()) and not bool(np.asarray(jdone).any())
        for name in ("pos", "quat", "vel", "ang"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(tobs["obs"].numpy(), np.asarray(jobs["obs"]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-4, rtol=0)
    assert float(tstate["vel"].abs().max()) > 0.05  # the ant moved
    assert int(tstate["steps"][0]) == 8


def test_ant_terminates_resets_and_truncates():
    env = ant.make_ant_env("ant_short")
    assert env.episode_len == 150 and ant.make_ant_env("ant").episode_len == 1000
    gen = torch.Generator().manual_seed(0)
    obs, state = env.reset(3, "cpu", generator=gen)
    state["pos"][0, :, 2] += 2.0  # env 0 far above the ground: unhealthy at once
    state["steps"][1] = 149  # env 1 at its time limit
    obs, state, rew, done, info = autoreset_step(env, state, torch.zeros((3, 8)), generator=gen)
    assert done.tolist() == [True, True, False]
    assert info["terminated"].tolist() == [True, False, False] and info["time_outs"].tolist() == [False, True, False]
    assert state["steps"].tolist() == [0, 0, 1]
    assert float(state["pos"][0, 0, 2]) < 1.0 and bool(torch.isfinite(obs["obs"]).all())


def test_discretized_is_a_discrete_space():
    space = Discretized(5, -1.0, 1.0)
    assert isinstance(space, Discrete) and num_action_parameters(space) == 5
    assert space.to_continuous(0) == -1.0 and space.to_continuous(4) == 1.0
    torch.testing.assert_close(space.to_continuous(torch.tensor([1, 2])), torch.tensor([-0.5, 0.0]))
