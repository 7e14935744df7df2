"""The port's batched GridBattleEnv against `jax.vmap` of the JAX env.

The JAX env's random draws are computed from the same keys as
`sample_factory_tpu/envs/device_env.py` splits them (vector_reset,
vector_step -> autoreset_step -> GridBattleEnv.step/reset) and fed to the
port, so that the two step one to one: obs, rewards, dones and time_outs are
compared for exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.envs.builtin.grid_battle import GridBattleEnv as JaxGridBattleEnv
from sample_factory_tpu.envs.device_env import vector_reset, vector_step
from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv
from sample_factory_tpu_torch.envs.builtin.synthetic import make_synthetic_env
from sample_factory_tpu_torch.envs.device_env import autoreset_step

torch.set_num_threads(1)


def _jax_reset_draws(env, keys):
    def one(key):
        k1, _ = jax.random.split(key)
        return jax.random.randint(k1, (env.num_enemies, 2), 0, env.size)

    return {"enemies": torch.tensor(np.asarray(jax.vmap(one)(keys)))}


def _jax_step_draws(env, key, num_envs):
    """The draws of vector_step(env, key, ...): per env, step_key/reset_key, then
    k_move/k_spawn inside GridBattleEnv.step (:79,85,106-107) and k1 in reset (:61-63)."""
    E = env.num_enemies

    def one(k):
        step_key, reset_key = jax.random.split(k)
        k_move, k_spawn = jax.random.split(step_key)
        return (
            jax.random.bernoulli(k_move, 0.5, (E, 1))[:, 0],
            jax.random.randint(k_spawn, (E, 2), 0, env.size),
            jax.random.bernoulli(k_spawn, 0.05, (E,)),
            reset_key,
        )

    stall, spawn, respawn, reset_keys = jax.vmap(one)(jax.random.split(key, num_envs))
    step = {"stall": torch.tensor(np.asarray(stall)), "spawn": torch.tensor(np.asarray(spawn)), "respawn": torch.tensor(np.asarray(respawn))}
    return step, _jax_reset_draws(env, reset_keys)


ENV_ARGS = [
    pytest.param((24, 8, 256, 6), id="grid_battle"),
    pytest.param((12, 4, 128, 5), id="grid_battle_small"),
    pytest.param((8, 6, 7, 3), id="crowded-short"),  # deaths, truncations and auto-resets within 20 steps
]


@pytest.mark.parametrize("env_args", ENV_ARGS)
def test_reset_and_autoreset_steps_match_jax(env_args):
    num_envs, steps = 16, 20
    jenv, tenv = JaxGridBattleEnv(*env_args), GridBattleEnv(*env_args)
    key = jax.random.PRNGKey(7)
    key, reset_key = jax.random.split(key)
    jobs, jstate = vector_reset(jenv, reset_key, num_envs)
    tobs, tstate = tenv.reset(num_envs, "cpu", draws=_jax_reset_draws(jenv, jax.random.split(reset_key, num_envs)))
    np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]))

    rng = np.random.default_rng(0)
    seen = {"terminated": 0, "truncated": 0, "hits": 0}
    for _ in range(steps):
        actions = rng.integers(0, 6, size=(num_envs, 1)).astype(np.int32)
        key, k = jax.random.split(key)
        jobs, jstate, jrew, jdone, jinfo = vector_step(jenv, k, jstate, jnp.asarray(actions))
        step_draws, reset_draws = _jax_step_draws(jenv, k, num_envs)
        tobs, tstate, trew, tdone, tinfo = autoreset_step(
            tenv, tstate, torch.tensor(actions), step_draws=step_draws, reset_draws=reset_draws
        )
        np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for name in ("time_outs", "terminated", "truncated"):
            np.testing.assert_array_equal(tinfo[name].numpy(), np.asarray(jinfo[name]))
        for name in ("agent", "enemies", "alive", "health", "steps"):
            np.testing.assert_array_equal(tstate[name].numpy(), np.asarray(jstate[name]))
        seen["terminated"] += int(tinfo["terminated"].sum())
        seen["truncated"] += int(tinfo["truncated"].sum())
        seen["hits"] += int((trew != 0).sum())
    assert seen["hits"] > 0
    if env_args[2] < steps:
        assert seen["terminated"] > 0 and seen["truncated"] > 0


def test_enemies_on_one_cell_add_up_before_the_clip():
    env = GridBattleEnv(size=6, num_enemies=3)
    draws = {"enemies": torch.tensor([[[1, 1], [1, 1], [4, 2]]])}
    obs, state = env.reset(1, "cpu", draws=draws)
    assert obs["obs"][0, 1, 1, 1] == 1.0 and obs["obs"][0, 4, 2, 1] == 1.0
    assert obs["obs"][0].sum(dim=(0, 1)).tolist() == [1.0, 2.0, 6.0]  # agent, 2 occupied cells, health bar
    state["alive"][0, 0] = False
    assert env._render_obs(state)["obs"][0, 1, 1, 1] == 1.0  # one alive enemy remains there


def test_generator_draws_are_reproducible():
    env = make_synthetic_env("grid_battle")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        obs, state = env.reset(4, "cpu", generator=gen)
        for _ in range(3):
            obs, state, rew, done, info = autoreset_step(env, state, torch.full((4, 1), 4), generator=gen)
        runs.append((obs["obs"], state["enemies"], rew))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][0].shape == (4, 24, 24, 3) and runs[0][2].dtype == torch.float32
