"""The port's GridDuel env and multi-agent auto-reset against the JAX package's.

The JAX env is written for one instance and run under `jax.vmap`; the port steps
[N, 2, ...] tensors. The JAX env's reset draws (two `randint(0, size // 3)` pairs from
the split reset key) are computed here from the same keys and injected into the port,
so every step is compared value for value: integers and flags exactly, observations
and rewards exactly too (they are sums of a few small float32 constants).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.envs.builtin.grid_duel import GridDuelEnv as JaxGridDuelEnv
from sample_factory_tpu.envs.builtin.grid_duel import make_grid_duel_env as jax_make_grid_duel_env
from sample_factory_tpu.envs.device_env import vector_step_ma
from sample_factory_tpu_torch.envs.builtin.grid_duel import GridDuelEnv, make_grid_duel_env
from sample_factory_tpu_torch.envs.device_env import autoreset_step_ma

torch.set_num_threads(1)

ENV_ARGS = dict(size=10, episode_len=5, shoot_range=3, health=2.0)

# one env per rule: positions of the two agents, health, steps so far, actions
SCENARIOS = [
    # moves into the walls are clipped: agent 0 north from row 0, agent 1 east from column 9
    dict(pos=[[0, 0], [9, 9]], health=[2.0, 2.0], steps=0, actions=[0, 3]),
    # an aligned shot in range (same row, 2 columns apart) hits; the idle opponent takes the damage
    dict(pos=[[5, 1], [5, 3]], health=[2.0, 2.0], steps=0, actions=[4, 5]),
    # the same row, 7 columns apart with range 3: both shots miss
    dict(pos=[[5, 1], [5, 8]], health=[2.0, 2.0], steps=0, actions=[4, 4]),
    # a simultaneous kill: both die, neither wins, the env terminates
    dict(pos=[[2, 4], [4, 4]], health=[1.0, 1.0], steps=1, actions=[4, 4]),
    # a single kill in a column: the win reward goes to the shooter alone
    dict(pos=[[6, 7], [4, 7]], health=[2.0, 1.0], steps=2, actions=[4, 1]),
    # the time limit: the fifth step truncates, nobody is dead
    dict(pos=[[1, 1], [8, 8]], health=[2.0, 1.0], steps=4, actions=[5, 2]),
    # a move that brings the agents into line counts before the shot of the same step
    dict(pos=[[3, 3], [4, 5]], health=[2.0, 2.0], steps=0, actions=[1, 4]),
]


def _states():
    return {
        "pos": np.asarray([s["pos"] for s in SCENARIOS], np.int32),
        "health": np.asarray([s["health"] for s in SCENARIOS], np.float32),
        "steps": np.asarray([s["steps"] for s in SCENARIOS], np.int32),
    }


def _to_torch(state):
    return {"pos": torch.tensor(np.asarray(state["pos"])).long(), "health": torch.tensor(np.asarray(state["health"])),
            "steps": torch.tensor(np.asarray(state["steps"])).long()}


def _assert_state_equal(tstate, jstate, where):
    for k in ("pos", "health", "steps"):
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]), err_msg=f"{where}: {k}")


def _jax_reset_draws(env, reset_keys):
    """What `env.reset(key)` draws, for each key: randint(k1) and randint(k2) of split(key)."""
    q = env.size // 3
    pairs = [jax.random.split(k) for k in reset_keys]
    p0 = np.stack([np.asarray(jax.random.randint(k1, (2,), 0, q)) for k1, _ in pairs])
    p1 = np.stack([np.asarray(jax.random.randint(k2, (2,), 0, q)) for _, k2 in pairs])
    return {"p0": torch.tensor(p0), "p1": torch.tensor(p1)}


def test_reset_matches_jax_and_is_egocentric():
    jenv, tenv = JaxGridDuelEnv(**ENV_ARGS), GridDuelEnv(**ENV_ARGS)
    keys = jax.random.split(jax.random.PRNGKey(0), 6)
    jobs, jstate = jax.vmap(jenv.reset)(keys)
    tobs, tstate = tenv.reset(6, "cpu", draws=_jax_reset_draws(jenv, keys))
    _assert_state_equal(tstate, jstate, "reset")
    np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]))
    assert tobs["obs"].shape == (6, 2, 10, 10, 3)
    # what agent 0 sees as itself, agent 1 sees as the opponent
    assert torch.equal(tobs["obs"][:, 0, :, :, 0], tobs["obs"][:, 1, :, :, 1])
    # the port's own draws stay inside the corner thirds
    _, own = tenv.reset(64, "cpu", generator=torch.Generator().manual_seed(0))
    assert own["pos"][:, 0].max() < 3 and own["pos"][:, 1].min() > 6


def test_scripted_steps_match_jax():
    jenv, tenv = JaxGridDuelEnv(**ENV_ARGS), GridDuelEnv(**ENV_ARGS)
    n = len(SCENARIOS)
    states = _states()
    actions = np.asarray([s["actions"] for s in SCENARIOS], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    jobs, jstate, jrew, jterm, jtrunc, jinfo = jax.vmap(jenv.step)(keys, {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(actions))
    tobs, tstate, trew, tterm, ttrunc, tinfo = tenv.step(_to_torch(states), torch.tensor(actions))
    _assert_state_equal(tstate, jstate, "scripted step")
    np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]))
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(tinfo["active"].numpy(), np.asarray(jinfo["active"]))
    # and the rules themselves, so that an error shared by both sides would show
    assert tstate["pos"][0].tolist() == [[0, 0], [9, 9]]
    assert trew[1].tolist() == [1.0, -0.5] and tstate["health"][1].tolist() == [2.0, 1.0]
    assert trew[2].tolist() == [0.0, 0.0]
    assert trew[3].tolist() == [0.5, 0.5] and tterm[3].all() and not ttrunc[3].any()  # no win reward for a double kill
    assert trew[4].tolist() == [3.0, -0.5] and tterm[4].all()
    assert ttrunc[5].all() and not tterm[5].any() and trew[5].tolist() == [0.0, 0.0]
    assert trew[6].tolist() == [-0.5, 1.0]  # agent 0 stepped into agent 1's row: agent 1's shot hits
    # actions with a trailing axis of 1, as the sampler stores them
    trailing = tenv.step(_to_torch(states), torch.tensor(actions)[..., None])
    assert torch.equal(trailing[2], trew) and torch.equal(trailing[0]["obs"], tobs["obs"])
    # the health bar: row 0 of channel 2, `health / max_health` of the width
    assert tobs["obs"][1, 1, 0, :, 2].tolist() == [1.0] * 5 + [0.0] * 5 and tobs["obs"][1, 0, 0, :, 2].sum() == 10


def test_random_walk_and_shaped_step_match_jax():
    """12 steps of random actions from the scripted states, without auto-reset, with per-agent
    [N, 2] shaping coefficients (as the mixed-policy rollout passes them)."""
    jenv, tenv = JaxGridDuelEnv(**ENV_ARGS), GridDuelEnv(**ENV_ARGS)
    n = len(SCENARIOS)
    rng = np.random.default_rng(0)
    shaping = {k: rng.uniform(0.2, 3.0, size=(n, 2)).astype(np.float32) for k in ("hit_reward", "hit_penalty", "win_reward")}
    jstate = {k: jnp.asarray(v) for k, v in _states().items()}
    tstate = _to_torch(_states())
    hits = 0
    for t in range(12):
        actions = rng.integers(0, 6, size=(n, 2)).astype(np.int32)
        actions[:, 0] = np.where(rng.random(n) < 0.5, 4, actions[:, 0])  # shoot often
        keys = jax.random.split(jax.random.PRNGKey(t), n)
        jobs, jstate, jrew, jterm, jtrunc, _ = jax.vmap(jenv.step_shaped)(
            keys, jstate, jnp.asarray(actions), {k: jnp.asarray(v) for k, v in shaping.items()})
        tobs, tstate, trew, tterm, ttrunc, _ = tenv.step(tstate, torch.tensor(actions), shaping={k: torch.tensor(v) for k, v in shaping.items()})
        _assert_state_equal(tstate, jstate, f"step {t}")
        np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]), err_msg=f"step {t}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-6, err_msg=f"step {t}")
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        hits += int((trew != 0).sum())
    assert hits > 0


def test_autoreset_step_ma_matches_jax():
    """10 steps through the multi-agent auto-reset of both packages: the env resets only when
    all of its agents are done, `done` is that flag for both agents, `time_outs` is truncated
    and not terminated, and the reset state is the one the JAX keys draw."""
    jenv, tenv = JaxGridDuelEnv(**ENV_ARGS), GridDuelEnv(**ENV_ARGS)
    n = len(SCENARIOS)
    rng = np.random.default_rng(1)
    jstate = {k: jnp.asarray(v) for k, v in _states().items()}
    tstate = _to_torch(_states())
    seen = {"terminated": 0, "time_outs": 0}
    for t in range(10):
        actions = rng.integers(0, 6, size=(n, 2)).astype(np.int32)
        if t == 0:
            actions = np.asarray([s["actions"] for s in SCENARIOS], np.int32)
        key = jax.random.PRNGKey(100 + t)
        jobs, jstate, jrew, jdone, jinfo = vector_step_ma(jenv, key, jstate, jnp.asarray(actions))
        # vector_step_ma gives each env split(key, N)[i]; autoreset_step_ma resets with the second half of its split
        reset_keys = [jax.random.split(k)[1] for k in jax.random.split(key, n)]
        tobs, tstate, trew, tdone, tinfo = autoreset_step_ma(tenv, tstate, torch.tensor(actions), reset_draws=_jax_reset_draws(jenv, reset_keys))
        _assert_state_equal(tstate, jstate, f"step {t}")
        np.testing.assert_array_equal(tobs["obs"].numpy(), np.asarray(jobs["obs"]), err_msg=f"step {t}")
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for k in ("terminated", "truncated", "time_outs", "active"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=f"step {t}: {k}")
        assert tdone.shape == (n, 2) and torch.equal(tdone[:, 0], tdone[:, 1])
        assert torch.equal(tdone[:, 0], (tinfo["terminated"] | tinfo["truncated"]).all(dim=1))
        # a finished env is back at step 0 with full health
        assert (tstate["steps"][tdone[:, 0]] == 0).all() and (tstate["health"][tdone[:, 0]] == 2.0).all()
        seen["terminated"] += int(tinfo["terminated"].sum())
        seen["time_outs"] += int(tinfo["time_outs"].sum())
    assert seen["terminated"] > 0 and seen["time_outs"] > 0


def test_registered_variants_match_jax():
    for name in ("grid_duel", "grid_duel_small"):
        jenv, tenv = jax_make_grid_duel_env(name), make_grid_duel_env(name)
        for attr in ("size", "episode_len", "shoot_range", "max_health", "num_agents", "reward_shaping", "supports_dynamic_shaping"):
            assert getattr(tenv, attr) == getattr(jenv, attr), (name, attr)
        assert tuple(tenv.obs_space["obs"].shape) == tuple(jenv.obs_space["obs"].shape) and tenv.action_space.n == jenv.action_space.n


@pytest.mark.parametrize("size", [12, 16], ids=["grid_duel_small", "grid_duel"])
@pytest.mark.parametrize("arch", ["convnet_simple", "convnet_impala"])
def test_valid_conv_stacks_see_nothing_of_a_duel_frame(arch, size):
    """Every grid_duel test of the JAX package trains `convnet_simple` on 12x12 frames: its
    VALID stack (8/4, 4/2, 3/2) leaves 2x2 after the first conv and 0x0 after the second (3x3
    then 0x0 at 16x16; `convnet_impala` fares the same), so the policy is blind. The port
    refuses such an encoder; `resnet_impala` (SAME convs: 16 -> 8 -> 4 -> 2) sees the frame."""
    from sample_factory_tpu_torch.cfg.arguments import default_cfg
    from sample_factory_tpu_torch.models.encoder import ConvEncoder, ResnetEncoder

    cfg = default_cfg(env="e", argv=[f"--encoder_conv_architecture={arch}", "--device=cpu"])
    with pytest.raises(ValueError, match=f"{arch} on a {size}x{size} observation leaves a 0x0"):
        ConvEncoder(cfg, (size, size, 3))
    resnet = ResnetEncoder(default_cfg(env="e", argv=["--encoder_conv_architecture=resnet_impala", "--device=cpu"]), (size, size, 3))
    assert resnet.conv_out_hwc == (2, 2, 32)  # 12 -> 6 -> 3 -> 2 as well
