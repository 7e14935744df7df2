"""Populations in the port against the JAX package: the agent-policy mapping, the mixed-policy
rollout value for value, each policy's train call on a shared trajectory, PBT's decisions and
mutated values, and the population runner end to end on the CPU.

Inputs come from numpy generators with fixed seeds, parameters are carried by the bridge,
both sides compute in float32; each tolerance is stated where it is used. Random draws are
never matched by seed: actions are made deterministic by a spiked action-head bias (as
`tests/test_device_self_play.py:75-86` does), env draws are injected or never taken.
"""

import glob
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sample_factory_tpu.algo.agent_policy_mapping import AgentPolicyMapping as JaxAgentPolicyMapping
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.algo.sampling import init_mixed_sampler_state as jax_init_mixed_sampler_state
from sample_factory_tpu.algo.sampling import init_sampler_state as jax_init_sampler_state
from sample_factory_tpu.algo.sampling import make_mixed_rollout_fn as jax_make_mixed_rollout_fn
from sample_factory_tpu.algo.sampling import make_rollout_fn as jax_make_rollout_fn
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.builtin.grid_duel import GridDuelEnv as JaxGridDuelEnv
from sample_factory_tpu.envs.builtin.synthetic import SyntheticVectorDiscreteEnv as JaxSyntheticVectorDiscreteEnv
from sample_factory_tpu.envs.device_env import DeviceEnv as JaxDeviceEnv
from sample_factory_tpu.envs.env_info import extract_env_info as jax_extract_env_info
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu.pbt.pbt import PopulationBasedTraining as JaxPopulationBasedTraining
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.agent_policy_mapping import AgentPolicyMapping
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.sampling import (
    TRAJECTORY_KEYS,
    init_mixed_sampler_state,
    init_sampler_state,
    make_mixed_rollout_fn,
    make_rollout_fn,
)
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.builtin.grid_duel import GridDuelEnv
from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticVectorDiscreteEnv
from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.env_info import EnvInfo, extract_env_info
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.pbt.pbt import PopulationBasedTraining, policy_cfg_file, policy_reward_shaping_file
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bias_action(params, action_idx: int, scale: float = 50.0):
    """Parameters whose action head always emits `action_idx`: a spike in its bias."""

    def edit(path, leaf):
        names = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
        if any("action_parameterization" in n for n in names) and names[-1] == "bias":
            return jnp.zeros_like(leaf).at[action_idx].set(scale)
        return leaf

    return jax.tree_util.tree_map_with_path(edit, params)


def _assert_traj_equal(ttraj, jtraj, atol=1e-5):
    """Every key of the trajectory: integers exactly, floats to `atol` (float32 sums of a
    narrow network in another order)."""
    assert set(ttraj) == set(jtraj) == set(TRAJECTORY_KEYS)
    for key in TRAJECTORY_KEYS:
        pairs = [(ttraj[key][k], jtraj[key][k], f"obs/{k}") for k in jtraj[key]] if key == "obs" else [(ttraj[key], jtraj[key], key)]
        for t, j, name in pairs:
            j = np.asarray(j)
            assert tuple(t.shape) == j.shape, name
            if np.issubdtype(j.dtype, np.integer):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
            else:
                np.testing.assert_allclose(t.numpy(), j, atol=atol, rtol=0, err_msg=name)


# ------------------------------------------------------------ agent-policy mapping


class _Info:
    def __init__(self, num_agents):
        self.num_agents = num_agents


@pytest.mark.parametrize("mix", [True, False])
@pytest.mark.parametrize("async_rl", [True, False])
def test_agent_policy_mapping_matches_jax(mix, async_rl):
    argv = [f"--pbt_mix_policies_in_one_env={mix}", f"--async_rl={async_rl}", "--num_policies=3", "--seed=11"]
    jmap = JaxAgentPolicyMapping(jax_default_cfg(env="e", argv=argv), _Info(2))
    tmap = AgentPolicyMapping(default_cfg(env="e", argv=argv + ["--device=cpu"]), _Info(2))
    jslots, tslots = jmap.initial_slot_policies(24), tmap.initial_slot_policies(24)
    assert tslots.dtype == jslots.dtype == np.int32
    np.testing.assert_array_equal(tslots, jslots)
    if mix and not async_rl:
        assert tslots.tolist() == [s % 3 for s in range(24)]
    if not mix:
        assert tslots.tolist() == [e % 3 for e in range(12) for _ in range(2)]
    # the resampling draws, too (no runner calls it, on either side)
    for episodes in (50, 50, 50):
        jslots, tslots = jmap.maybe_resample(jslots, episodes), tmap.maybe_resample(tslots, episodes)
        np.testing.assert_array_equal(tslots, jslots)


# ------------------------------------------------------------ rollouts, value for value

ROLLOUT_ARGV = [
    "--use_rnn=True", "--rnn_size=16", "--encoder_conv_architecture=resnet_impala", "--encoder_conv_mlp_layers", "16",
    "--encoder_mlp_layers", "16", "--rollout=8", "--recurrence=8", "--normalize_input=True", "--reward_scale=0.5", "--seed=0",
]


def _two_policies(jcfg, tcfg, jenv, tenv, example_obs, actions):
    """Two flax parameter sets from different keys with spiked action heads, stacked for the
    JAX rollout and carried into two modules of the port; per-policy observation normalizers
    with different statistics on both sides."""
    jinfo, tinfo = jax_extract_env_info(jenv, jcfg), extract_env_info(tenv, tcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    rng = np.random.default_rng(5)
    jstates, tstates = [], []
    for p, action in enumerate(actions):
        jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(10 + p), example_obs)
        jts = jts.replace(params=_bias_action(jts.params, action))
        shape = jts.obs_rms["obs"].running_mean.shape
        mean, var = rng.uniform(0.0, 0.3, shape).astype(np.float32), rng.uniform(0.5, 1.5, shape).astype(np.float32)
        jts = jts.replace(obs_rms={"obs": jts.obs_rms["obs"].replace(running_mean=jnp.asarray(mean), running_var=jnp.asarray(var))})
        tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
        bridge.load_flax_params(tmodel, _np_tree(jts.params))
        tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
        tts.obs_rms = {"obs": replace(tts.obs_rms["obs"], running_mean=torch.tensor(mean), running_var=torch.tensor(var))}
        jstates.append(jts)
        tstates.append(tts)
    return jinfo, tinfo, jmodel, tx, jstates, tstates


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _mixed_rollouts(jenv, tenv, num_envs, actions, versions, shaping=None):
    argv = ROLLOUT_ARGV + [f"--num_envs={num_envs}"]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    jss = jax_init_mixed_sampler_state(jcfg, jenv, jax.random.PRNGKey(0), num_envs, 2)
    tss = init_mixed_sampler_state(tcfg, tenv, num_envs, 2, "cpu", torch.Generator().manual_seed(0))
    # the port starts from the JAX sampler's env states and observations
    tss.env_states = {k: torch.tensor(np.asarray(v)).to(tss.env_states[k].dtype) for k, v in jss.env_states.items()}
    tss.obs = {k: torch.tensor(np.asarray(v)) for k, v in jss.obs.items()}
    if shaping is not None:
        jss = jss.replace(shaping={k: jnp.asarray(v, jnp.float32) for k, v in shaping.items()})
        tss.shaping = {k: torch.tensor(v, dtype=torch.float32) for k, v in shaping.items()}
    example_obs = {k: v[:2] for k, v in jss.obs.items()}
    jinfo, tinfo, jmodel, tx, jstates, tstates = _two_policies(jcfg, tcfg, jenv, tenv, example_obs, actions)
    slot_policies = np.asarray([0, 1] * num_envs, np.int32)  # mixed within every env
    jrollout = jax.jit(jax_make_mixed_rollout_fn(jcfg, jenv, jinfo, jmodel, 2))
    jss, jtraj, jep = jrollout(_stack([s.params for s in jstates]), _stack([s.obs_rms for s in jstates]), jss,
                               jnp.asarray(slot_policies), jnp.asarray(versions))
    trollout = make_mixed_rollout_fn(tcfg, tenv, tinfo, 2)
    tss, ttraj, tep = trollout([s.model for s in tstates], [s.obs_rms for s in tstates], tss, slot_policies, versions)
    return (jss, jtraj, jep), (tss, ttraj, tep), (jcfg, tcfg, jinfo, tinfo, jmodel, tx, jstates, tstates)


def test_mixed_rollout_matches_jax_value_for_value():
    """GridDuel 8x8 with episodes longer than the rollout, so that no reset (whose draws differ)
    falls inside it. Policy 0 (agent 0 of every env) always shoots, policy 1 always walks north
    into agent 0's rows, so hits, penalties and per-policy shaping all show in the rewards."""
    env_args = dict(size=8, episode_len=16, shoot_range=8, health=100.0)
    shaping = {"hit_reward": [1.0, 3.0], "hit_penalty": [0.5, 0.25], "win_reward": [2.0, 2.0]}
    (jss, jtraj, jep), (tss, ttraj, tep), _ = _mixed_rollouts(
        JaxGridDuelEnv(**env_args), GridDuelEnv(**env_args), num_envs=6, actions=(4, 0), versions=[7, 9], shaping=shaping)
    _assert_traj_equal(ttraj, jtraj)
    T, slots = 8, 12
    assert ttraj["obs"]["obs"].shape[:2] == (T + 1, slots) and ttraj["rnn_states"].shape[0] == T + 1
    assert (ttraj["actions"][:, 0::2] == 4).all() and (ttraj["actions"][:, 1::2] == 0).all()
    assert (ttraj["policy_version"][:, 0::2] == 7).all() and (ttraj["policy_version"][:, 1::2] == 9).all()
    assert (ttraj["policy_id"][:, 0::2] == 0).all() and (ttraj["policy_id"][:, 1::2] == 1).all()
    # rewards: policy 0's hits at its own hit_reward (scaled by 0.5), policy 1's penalties at its own
    assert set(ttraj["rewards"][:, 0::2].unique().tolist()) == {0.0, 0.5}
    assert set(ttraj["rewards"][:, 1::2].unique().tolist()) == {0.0, -0.125}
    assert ttraj["dones"].sum() == 0
    for k in jep:
        np.testing.assert_allclose(tep[k].numpy(), np.asarray(jep[k]), atol=1e-5, err_msg=k)
    # the carried state: accumulators of the unfinished episodes, slot-major
    np.testing.assert_allclose(tss.ep_return.numpy(), np.asarray(jss.ep_return), atol=1e-5)
    np.testing.assert_allclose(tss.ep_return_raw.numpy(), np.asarray(jss.ep_return_raw), atol=1e-5)
    np.testing.assert_array_equal(tss.ep_len.numpy(), np.asarray(jss.ep_len))
    np.testing.assert_array_equal(tss.env_states["pos"].numpy(), np.asarray(jss.env_states["pos"]))


class _JaxStubEnv(JaxDeviceEnv):
    """A deterministic 2-agent env (no draws): 3-step episodes that end when both agents are done
    (agent 0 a step before agent 1), agent 1 inactive on even steps."""

    num_agents = 2

    def __init__(self):
        self.obs_space = jax_dict_spec({"obs": JBox((4,), 0.0, 4.0)})
        self.action_space = JDiscrete(5)

    def _obs(self, t):
        t = t.astype(jnp.float32)
        return {"obs": jnp.stack([jnp.stack([t, 0.0 * t, t * 0.5, 1.0 + 0.0 * t]), jnp.stack([t, 1.0 + 0.0 * t, t * 0.25, 0.0 * t])])}

    def reset(self, key):
        t = jnp.zeros((), jnp.int32)
        return self._obs(t), {"t": t}

    def step(self, key, state, action):
        a = (action[..., 0] if action.ndim > 1 else action).astype(jnp.float32)
        t = state["t"] + 1
        reward = a * 0.1 + jnp.asarray([1.0, -1.0]) * t.astype(jnp.float32)
        terminated = jnp.stack([t >= 2, t >= 3])  # agent 0 is done a step early: the env goes on until both are
        info = {"active": jnp.stack([jnp.asarray(True), t % 2 == 1])}
        return self._obs(t), {"t": t}, reward, terminated, jnp.zeros((2,), bool), info


class _StubEnv(DeviceEnv):
    """The same env for the port, batched."""

    num_agents = 2

    def __init__(self):
        self.obs_space = make_dict_spec({"obs": Box((4,), 0.0, 4.0)})
        self.action_space = Discrete(5)

    def _obs(self, t):
        t = t.float()
        zero, one = torch.zeros_like(t), torch.ones_like(t)
        return {"obs": torch.stack([torch.stack([t, zero, t * 0.5, one], -1), torch.stack([t, one, t * 0.25, zero], -1)], 1)}

    def _reset(self, num_envs, device, draws):
        t = torch.zeros(num_envs, dtype=torch.int64, device=device)
        return self._obs(t), {"t": t}

    def _step(self, state, actions, draws, shaping):
        a = (actions[..., 0] if actions.dim() > 2 else actions).float()
        t = state["t"] + 1
        reward = a * 0.1 + torch.tensor([1.0, -1.0]) * t.float()[:, None]
        terminated = torch.stack([t >= 2, t >= 3], 1)
        info = {"active": torch.stack([torch.ones_like(t, dtype=torch.bool), t % 2 == 1], 1)}
        return self._obs(t), {"t": t}, reward, terminated, torch.zeros_like(terminated), info


def test_mixed_rollout_marks_inactive_agents_and_sums_per_policy():
    """A stub env on both sides with episodes that end inside the rollout (its reset draws
    nothing) and an `active` mask with zeros: policy_id is -1 exactly where the agent is
    inactive, the rnn state is zero after a done, and the episodic sums come back per policy."""
    (jss, jtraj, jep), (tss, ttraj, tep), _ = _mixed_rollouts(_JaxStubEnv(), _StubEnv(), num_envs=3, actions=(2, 4), versions=[1, 5])
    _assert_traj_equal(ttraj, jtraj)
    pid = ttraj["policy_id"]
    assert (pid[:, 0::2] == 0).all()
    assert pid[:, 1].tolist() == [1, -1, 1, 1, -1, 1, 1, -1]  # steps 1, 2, 3 of each episode: inactive on step 2
    assert ttraj["dones"][:, 0].tolist() == [0, 0, 1, 0, 0, 1, 0, 0]
    assert (ttraj["rnn_states"][3] == 0).all() and (ttraj["rnn_states"][2] != 0).any()
    for k in jep:
        assert tep[k].shape == (2,)
        np.testing.assert_allclose(tep[k].numpy(), np.asarray(jep[k]), atol=1e-5, err_msg=k)
    # 2 episodes an env and policy; raw return of an episode: 3 * 0.1 * action + (1 + 2 + 3) * (+1 or -1)
    assert tep["count"].tolist() == [6.0, 6.0] and tep["len_sum"].tolist() == [18.0, 18.0]
    np.testing.assert_allclose(tep["raw_return_sum"].numpy(), [6 * (0.6 + 6.0), 6 * (1.2 - 6.0)], atol=1e-4)
    np.testing.assert_allclose(tep["return_sum"].numpy(), 0.5 * tep["raw_return_sum"].numpy(), atol=1e-4)


class _ReplayEnv(SyntheticVectorDiscreteEnv):
    """The port's synthetic env fed a recorded sequence of observations: whatever the step or
    the reset would draw at step t is the observation that followed step t in the recording."""

    def __init__(self, recorded_obs, **kwargs):
        super().__init__(**kwargs)
        self.recorded, self.t = recorded_obs, 0

    def step_draws(self, num_envs, generator, device):
        self.t += 1
        return {"obs": self.recorded[self.t]}

    def reset_draws(self, num_envs, generator, device):
        return {"obs": self.recorded[self.t]}


def test_single_policy_rollout_matches_jax_value_for_value():
    """The single-policy rollout on a synthetic env with 5-step episodes, so that resets fall
    inside the rollout: the port replays the JAX rollout's observations (the env's only draws)
    and must give every other key, the rnn resets and the episodic sums: floats 1e-5."""
    N = 6
    argv = [a for a in ROLLOUT_ARGV if "resnet" not in a] + [f"--num_envs={N}"]
    jcfg, tcfg = jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])
    kwargs = dict(num_actions=5, episode_len=5)
    jenv = JaxSyntheticVectorDiscreteEnv(**kwargs)
    jinfo = jax_extract_env_info(jenv, jcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    jss = jax_init_sampler_state(jcfg, jenv, jax.random.PRNGKey(0), N)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(1), jss.obs)
    jts = jts.replace(params=_bias_action(jts.params, 3))
    _, jtraj, jep = jax.jit(jax_make_rollout_fn(jcfg, jenv, jinfo, jmodel), static_argnums=(4,))(jts.params, jts.obs_rms, jss, 6, 0)

    tenv = _ReplayEnv(torch.tensor(np.asarray(jtraj["obs"]["obs"])), **kwargs)
    tinfo = extract_env_info(tenv, tcfg)
    tmodel = bridge.load_flax_params(create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space), _np_tree(jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    tss = init_sampler_state(tcfg, tenv, N, "cpu", torch.Generator().manual_seed(0))
    tss, ttraj, tep = make_rollout_fn(tcfg, tenv, tinfo)(tmodel, tts.obs_rms, tss, 6, 0)
    _assert_traj_equal(ttraj, jtraj)
    assert ttraj["dones"][4].all() and ttraj["dones"].sum() == N and (ttraj["rnn_states"][5] == 0).all()
    assert (ttraj["actions"] == 3).all() and (ttraj["policy_version"] == 6).all()
    for k in jep:
        np.testing.assert_allclose(float(tep[k]), float(jep[k]), atol=1e-5, err_msg=k)
    assert float(tep["count"]) == N and float(tep["len_sum"]) == 5 * N


# ------------------------------------------------------------ per-policy train calls


@pytest.mark.parametrize("inactive", [False, True], ids=["all-active", "inactive-rows"])
def test_each_policy_train_call_on_shared_trajectory_matches_jax(inactive):
    """One mixed trajectory (the stub env's, GRU core, so the other policy's slots are invalid
    for whole segments and go through the BPTT resets), then for p in {0, 1} the port's
    train(ts_p, traj, pid=p) against the JAX train_fn(ts_p, traj, key, p): parameters,
    normalizers and stats to 1e-5, the learning rate scaled by the valid fraction. With
    `inactive`, the trajectory keeps the env's -1 ids; without, every agent counts as active."""
    (_, jtraj, _), (_, ttraj, _), (jcfg, tcfg, jinfo, tinfo, jmodel, tx, jstates, tstates) = _mixed_rollouts(
        _JaxStubEnv(), _StubEnv(), num_envs=4, actions=(2, 4), versions=[0, 0])
    if not inactive:
        ids = np.tile(np.asarray([0, 1], np.int32), (8, 4))
        jtraj = dict(jtraj, policy_id=jnp.asarray(ids))
        ttraj = dict(ttraj, policy_id=torch.tensor(ids))
    assert bool((ttraj["policy_id"] == -1).any()) == inactive
    for cfg in (jcfg, tcfg):
        cfg.batch_size, cfg.num_epochs, cfg.learning_rate = 32, 1, 1e-3
    jtrain = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx, 0), static_argnums=(3,))
    ttrain = make_train_fn(tcfg, tinfo, 0)
    for p in (0, 1):
        jts, tts = jstates[p].replace(curr_lr=jnp.asarray(1e-3, jnp.float32)), tstates[p]
        tts.curr_lr = 1e-3
        jts2, jstats = jtrain(jts, jtraj, jax.random.PRNGKey(p), p)
        tstats = ttrain(tts, ttraj, torch.Generator().manual_seed(p), pid=p)
        # 8 slots x 8 steps = 64 samples, 2 minibatches: each holds 2 of this policy's slots and 2 foreign ones
        expected = {(False, 0): 0.5, (False, 1): 0.5, (True, 0): 0.5, (True, 1): 0.5 * 5 / 8}[(inactive, p)]
        assert float(tstats["valids_fraction"]) == pytest.approx(expected) == pytest.approx(float(jstats["valids_fraction"]))
        assert tts.train_step == int(jts2.train_step) == 2
        want = bridge.flax_to_state_dict(_np_tree(jts2.params), tts.model)
        before = bridge.flax_to_state_dict(_np_tree(jts.params), tts.model)
        moved = 0
        for name, value in tts.model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=f"policy {p}: {name}")
            moved += int(not np.allclose(value.numpy(), before[name].numpy(), atol=1e-7))
        assert moved > len(want) // 2  # the update is real; the spiked action head is saturated and gets no gradient
        np.testing.assert_allclose(tts.obs_rms["obs"].running_mean.numpy(), np.asarray(jts2.obs_rms["obs"].running_mean), atol=1e-5)
        np.testing.assert_allclose(tts.obs_rms["obs"].running_var.numpy(), np.asarray(jts2.obs_rms["obs"].running_var), atol=1e-5)
        np.testing.assert_allclose(float(tts.obs_rms["obs"].count), float(jts2.obs_rms["obs"].count))
        assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
        for key in ("valids_fraction", "epochs_executed", "lr", "version_diff_max"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), atol=1e-5, err_msg=key)
        # the LR of the step: curr_lr x valid fraction (both minibatches, so the summary minibatch does not matter)
        assert float(tstats["actual_lr"]) == pytest.approx(1e-3 * expected) == pytest.approx(float(jstats["actual_lr"]))
        assert all(bool(torch.isfinite(v).all()) for v in tstats.values())


# ------------------------------------------------------------ PBT

PBT_ARGV = [
    "--seed=7", "--with_pbt=True", "--num_policies=4", "--pbt_replace_fraction=0.5", "--pbt_mutation_rate=0.8",
    "--pbt_optimize_gamma=True", "--pbt_start_mutation=1000", "--pbt_period_env_steps=500", "--pbt_replace_reward_gap=0.05",
    "--lr_schedule=constant", "--experiment=pbt",
]
SHAPING = {"kill_reward": 1.0, "hit_penalty": 0.2, "nested": {"bonus": 2.0, "pair": (0.5, 3), "flag": True, "name": "x"}}


def _tiny_population(cfg, P, optimizer="adam", normalizers=False):
    """P train states of the port around small modules, after one optimizer step each."""
    argv = ["--use_rnn=False", "--encoder_mlp_layers", "8", f"--optimizer={optimizer}", "--lamb_lookahead=True", "--device=cpu",
            f"--normalize_input={normalizers}", f"--normalize_returns={normalizers}"]
    mcfg = default_cfg(env="e", argv=argv)
    info = EnvInfo(obs_space=make_dict_spec({"obs": Box((3,))}), action_space=Discrete(4), num_agents=1, is_device_env=True)
    gen = torch.Generator().manual_seed(0)
    states = []
    for p in range(P):
        ts = init_train_state(mcfg, info, create_actor_critic(mcfg, info.obs_space, info.action_space, gen), "cpu")
        logits, values, _ = ts.model({"obs": torch.rand(5, 3, generator=gen)}, torch.zeros(5, 1))
        (logits.sum() * (p + 1) + values.sum()).backward()
        ts.optimizer.step()
        ts.train_step = 10 * p
        if normalizers:
            ts.obs_rms = {"obs": replace(ts.obs_rms["obs"], running_mean=torch.full((3,), float(p)), count=torch.tensor(5.0 + p))}
            ts.returns_rms = replace(ts.returns_rms, running_var=torch.full((1,), 2.0 + p))
        states.append(ts)
    return states


def test_pbt_decisions_and_mutations_match_jax(tmp_path):
    """The same cfg, seed and objectives through both classes for 6 rounds: the same policies
    replaced by the same sources, `policy_hparams` and `policy_reward_shaping` equal to 1e-12
    (the same `random.Random` draws in the same order), the same JSON files, and the train
    state written the same way (hparams, constant-schedule LR, train_step bump)."""
    P = 4
    jcfg = jax_default_cfg(env="e", argv=PBT_ARGV + [f"--train_dir={tmp_path / 'jax'}"])
    tcfg = default_cfg(env="e", argv=PBT_ARGV + [f"--train_dir={tmp_path / 'torch'}", "--device=cpu"])
    from sample_factory_tpu.algo.learning import PolicyTrainState as JaxPolicyTrainState, default_hparams as jax_default_hparams

    jts = JaxPolicyTrainState(
        params={"w": jnp.stack([jnp.full((4,), float(p)) for p in range(P)])}, opt_state={"m": jnp.zeros((P, 4))},
        obs_rms=None, returns_rms=None, curr_lr=jnp.full((P,), jcfg.learning_rate), train_step=jnp.zeros((P,), jnp.int32),
        hparams=jax.vmap(lambda _: jax_default_hparams(jcfg))(jnp.arange(P)),
    )
    tstates = _tiny_population(tcfg, P)
    for p, ts in enumerate(tstates):
        ts.train_step = 0
        with torch.no_grad():
            ts.model.critic_linear.bias.fill_(float(p))  # a tag that shows where the weights came from
    jpbt = JaxPopulationBasedTraining(jcfg, P, default_reward_shaping=SHAPING)
    tpbt = PopulationBasedTraining(tcfg, P, default_reward_shaping=SHAPING)
    assert tpbt.hparams_to_tune == jpbt.hparams_to_tune and "gamma" in tpbt.hparams_to_tune

    rng = np.random.default_rng(3)
    rounds = [[None, 1.0, 2.0, 3.0]] + [list(rng.uniform(0.0, 5.0, P)) for _ in range(5)]
    rounds[2] = [0.1, 4.0, 3.0, 2.0]  # policy 0 is the worst: it inherits, unmutated
    for i, objectives in enumerate(rounds):
        steps = [1000 + 500 * i] * P
        assert tpbt.due(steps) == jpbt.due(steps) is True
        jts = jpbt.on_training_step(jts, steps, objectives)
        tpbt.on_training_step(tstates, steps, objectives)
        assert tpbt.last_update == jpbt.last_update
        for p in range(P):
            for name, value in jpbt.policy_hparams[p].items():
                assert tpbt.policy_hparams[p][name] == pytest.approx(value, rel=1e-12, abs=1e-12), (i, p, name)
            assert json.dumps(tpbt.policy_reward_shaping[p]) == json.dumps(jpbt.policy_reward_shaping[p]), (i, p)
            # the train state: hparams (float32 rows on the JAX side), LR, version
            for name, row in jts.hparams.items():
                assert tstates[p].hparams[name] == pytest.approx(float(row[p]), rel=1e-6), (i, p, name)
            assert tstates[p].curr_lr == pytest.approx(float(jts.curr_lr[p]), rel=1e-6)
            assert tstates[p].train_step == int(jts.train_step[p])
            # the weights came from the same source policy
            assert float(tstates[p].model.critic_linear.bias.detach()) == float(jts.params["w"][p, 0]), (i, p)
        assert [(p, json.dumps(s)) for p, s in tpbt.pending_shaping_updates] == [(p, json.dumps(s)) for p, s in jpbt.pending_shaping_updates]
        if i == 0:
            assert tpbt.last_update == [1000] * P and not tpbt.pending_shaping_updates  # objectives missing: nothing happens
        if i == 2:  # policy 0 took over a better policy's settings as they were: never mutated
            src = int(float(tstates[0].model.critic_linear.bias.detach()))
            assert src != 0 and tpbt.policy_hparams[0] == tpbt.policy_hparams[src] and tpbt.policy_reward_shaping[0] == tpbt.policy_reward_shaping[src]
    assert not tpbt.due([1000 + 500 * 5 + 100] * P)
    # something did mutate, and the files are the same on both sides
    assert any(tpbt.policy_hparams[p] != tpbt.default_hparams for p in range(1, P))
    jfiles = sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "jax" / "pbt" / "policy_*.json")))
    tfiles = sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "torch" / "pbt" / "policy_*.json")))
    assert jfiles == tfiles and len(tfiles) >= 4
    for name in tfiles:
        assert json.load(open(tmp_path / "torch" / "pbt" / name)) == json.load(open(tmp_path / "jax" / "pbt" / name)), name
    assert policy_cfg_file(tcfg, 1).endswith("policy_01_cfg.json") and policy_reward_shaping_file(tcfg, 1).endswith("policy_01_reward_shaping.json")


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_pbt_weight_replacement_copies_the_whole_policy(optimizer):
    """`_replace_weights(dst=2, src=0)` on a list of 3 (counterpart of
    `tests/test_multi_policy.py:70-96`): parameters, optimizer state (Adam's moments and step;
    LAMB's count and lookahead slow weights) and normalizers equal the source's and share no
    storage with it; policy 1 is untouched; dst's train_step rises by max_policy_lag + 1."""
    cfg = default_cfg(env="t", argv=["--seed=1", "--with_pbt=True", "--num_policies=3", "--device=cpu"])
    states = _tiny_population(cfg, 3, optimizer=optimizer, normalizers=True)
    untouched = {k: v.clone() for k, v in states[1].model.state_dict().items()}
    dst_tensors = [p.data_ptr() for p in states[2].model.parameters()]
    PopulationBasedTraining(cfg, 3)._replace_weights(states, dst=2, src=0)

    def tensors(ts):
        opt = ts.optimizer.state_dict()
        out = dict(ts.model.state_dict())
        for i, st in opt["state"].items():
            out.update({f"opt{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
        out.update({f"obs_rms.{k}": v for k, v in ts.obs_rms["obs"].state_dict().items()})
        out.update({f"returns_rms.{k}": v for k, v in ts.returns_rms.state_dict().items()})
        return out, opt["param_groups"]

    (src, src_groups), (dst, dst_groups) = tensors(states[0]), tensors(states[2])
    assert set(src) == set(dst) and any(k.startswith("opt") for k in src)
    assert any(k.endswith("slow") for k in src) == (optimizer == "lamb")
    for k in src:
        assert torch.equal(src[k], dst[k]), k
        assert src[k].data_ptr() != dst[k].data_ptr(), k
    assert src_groups == dst_groups and (optimizer == "adam" or dst_groups[0]["step"] == 1)
    assert [p.data_ptr() for p in states[2].model.parameters()] == dst_tensors  # copied into dst's own tensors
    for k, v in states[1].model.state_dict().items():
        assert torch.equal(v, untouched[k])
    assert states[2].train_step == 20 + cfg.max_policy_lag + 1 and states[0].train_step == 0 and states[1].train_step == 10
    # the copy is independent: a step of the source leaves the destination alone
    states[0].optimizer.step()
    assert not torch.equal(next(states[0].model.parameters()), next(states[2].model.parameters()))


def test_mutated_hparams_and_lr_survive_a_checkpoint(tmp_path):
    cfg = default_cfg(env="e", argv=PBT_ARGV + [f"--train_dir={tmp_path}", "--device=cpu"])
    states = _tiny_population(cfg, 4)
    pbt = PopulationBasedTraining(cfg, 4)
    pbt.on_training_step(states, [1000] * 4, [4.0, 3.0, 2.0, 1.0])
    mutated = states[3]
    assert mutated.hparams != states[0].hparams and mutated.curr_lr == mutated.hparams["learning_rate"] != cfg.learning_rate
    save_checkpoint(cfg, 3, mutated, env_steps=4000, best_performance=1.5)
    fresh = _tiny_population(cfg, 1)[0]
    assert load_checkpoint(cfg, 3, fresh) == (4000, 1.5)
    assert fresh.hparams == mutated.hparams and fresh.curr_lr == mutated.curr_lr and fresh.train_step == mutated.train_step
    torch.testing.assert_close(fresh.model.state_dict(), mutated.model.state_dict(), rtol=0, atol=0)


# ------------------------------------------------------------ the runner, end to end on the CPU


def _runner(argv, observers=()):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import make_rl_runner

    register_synthetic_components()
    cfg, runner = make_rl_runner(parse_custom_args(argv))
    for observer in observers:
        runner.register_observer(observer)
    runner.init()
    return cfg, runner


def _rigged_objective(values):
    """An observer that publishes a custom PBT objective (as `--pbt_target_objective` reads
    it from `policy_avg_stats`), so that the test decides which policy is the worst."""
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    class Rigged(AlgoObserver):
        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[v] for v in values]

    return Rigged()


def _summaries(exp_dir, p):
    with open(os.path.join(exp_dir, ".summary", str(p), "summaries.jsonl")) as f:
        return [json.loads(line) for line in f]


# grid_battle_small with resnet_impala: convnet_impala leaves a 0x0 map of its 12x12 frames, which the port refuses
POPULATION_ARGV = [
    "--env=grid_battle_small", "--experiment=gb_pbt", "--seed=0", "--device=cpu", "--num_policies=2", "--num_workers=2",
    "--num_envs_per_worker=16", "--rollout=16", "--batch_size=128", "--encoder_conv_architecture=resnet_impala",
    "--encoder_conv_mlp_layers", "32", "--use_rnn=False", "--with_pbt=True", "--pbt_start_mutation=2000",
    "--pbt_period_env_steps=2000", "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5", "--pbt_replace_reward_gap=0.0",
    "--pbt_replace_reward_gap_absolute=0.0", "--lr_schedule=constant", "--experiment_summaries_interval=1",
]


@pytest.fixture(scope="module")
def population_run(tmp_path_factory):
    """One population run with PBT for the tests below: 2 policies x 16 envs, 24 iterations, three
    PBT rounds (at 2048, 4096 and 6144 env steps a policy) in which policy 1 is the worst."""
    train_dir = tmp_path_factory.mktemp("population")
    argv = POPULATION_ARGV + [f"--train_dir={train_dir}", "--train_for_env_steps=12288"]
    cfg, runner = _runner(argv, [_rigged_objective([1.0, 0.0])])
    assert type(runner).__name__ == "MultiPolicyRunner" and not runner.mixed and runner.envs_per_policy == 16
    assert runner.run() == 0
    return cfg, runner, str(train_dir / "gb_pbt"), argv


def test_device_env_pbt_reward_shaping(population_run):
    """Counterpart of `tests/test_multi_policy.py:99-141`: PBT mutates policy 1's reward shaping
    and hyperparameters, writes both files, and the values reach the sampler state and the
    train state that the next iteration reads."""
    cfg, runner, exp, _ = population_run
    assert runner.env_steps == 12288 and runner.pbt.last_update == [6144, 6144]
    shaping = json.load(open(os.path.join(exp, "policy_01_reward_shaping.json")))
    hparams = json.load(open(os.path.join(exp, "policy_01_cfg.json")))
    assert set(shaping) == {"kill_reward", "hit_penalty"} and shaping != {"kill_reward": 1.0, "hit_penalty": 0.2}
    assert not os.path.exists(os.path.join(exp, "policy_00_cfg.json"))  # the best policy is left alone
    assert runner.sampler_state[1].shaping == shaping == runner.pbt.policy_reward_shaping[1]
    assert runner.sampler_state[0].shaping == {"kill_reward": 1.0, "hit_penalty": 0.2}
    ts0, ts1 = runner.train_state
    assert ts1.hparams == hparams == runner.pbt.policy_hparams[1] and ts0.hparams == runner.pbt.default_hparams
    assert hparams["learning_rate"] != cfg.learning_rate and hparams["gamma"] == cfg.gamma  # gamma only with --pbt_optimize_gamma
    assert ts1.curr_lr == hparams["learning_rate"] and ts0.curr_lr == cfg.learning_rate
    # three exploits of policy 0: 24 iterations x 2 SGD steps, plus three times max_policy_lag + 1
    assert ts0.train_step == 48 and ts1.train_step == 48 + 3 * (cfg.max_policy_lag + 1)
    for p in (0, 1):
        assert glob.glob(os.path.join(exp, f"checkpoint_p{p}", "checkpoint_*.pth"))
        records = [r for r in _summaries(exp, p) if "train/loss" in r]
        assert records and all(np.isfinite(r["train/loss"]) and r["train/valids_fraction"] == 1.0 for r in records)
        reported = {r["train/pbt_learning_rate"] for r in records}  # reports come by the clock: some round's value
        assert reported == {cfg.learning_rate} if p == 0 else reported - {cfg.learning_rate}
    assert all(es.total_episodes > 0 and np.isfinite(es.avg_reward) for es in runner.episode_stats_per_policy)
    assert all(np.isfinite(v) for stats in runner.host_stats() for v in stats.values())


def test_population_resumes_from_per_policy_checkpoints(population_run):
    cfg, runner, exp, argv = population_run
    _, resumed = _runner([a for a in argv if "train_for_env_steps" not in a] + ["--train_for_env_steps=13312"])
    assert resumed.env_steps == 12288
    for p in (0, 1):
        old, new = runner.train_state[p], resumed.train_state[p]
        assert new.train_step == old.train_step and new.hparams == old.hparams and new.curr_lr == old.curr_lr
        torch.testing.assert_close(new.model.state_dict(), old.model.state_dict(), rtol=0, atol=0)
    assert resumed.run() == 0 and resumed.env_steps == 13312
    assert open(os.path.join(exp, "done")).read() == "13312"
    assert [os.path.basename(f).split("_")[2] for f in sorted(glob.glob(os.path.join(exp, "checkpoint_p0", "checkpoint_*")))][-1] == "13312.pth"


def test_enjoy_policy_index_loads_that_policy(population_run):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    cfg, _, exp, _ = population_run
    base = ["--env=grid_battle_small", "--experiment=gb_pbt", f"--train_dir={os.path.dirname(exp)}", "--no_render", "--device=cpu"]
    episodes = []
    status, avg = enjoy(parse_custom_args(base + ["--policy_index=1"], evaluation=True), num_episodes=4, num_envs=8, collect_episodes=episodes)
    assert status == 0 and len(episodes) >= 4 and np.isfinite(avg)
    status, _ = enjoy(parse_custom_args(base + ["--policy_index=2"], evaluation=True), num_episodes=1, num_envs=2)
    assert status == 1  # no such policy in the run: no checkpoint
    from sample_factory_tpu_torch.eval import do_eval

    assert do_eval(parse_custom_args(base + ["--policy_index=1", "--sample_env_episodes=4"], evaluation=True)) == 0
    with open(os.path.join(exp, "eval", "eval_p1.csv")) as f:
        assert len(f.read().splitlines()) == 5  # the header and 4 episodes


@pytest.mark.parametrize("num_policies", [2, 1])
def test_grid_duel_selfplay_smoke(tmp_path, num_policies):
    """Counterpart of `tests/test_device_self_play.py:221-245`, with `resnet_impala` (the JAX
    test's convnet_simple sees a 0x0 map of the 12x12 frames) and a GRU core: mixed self-play
    runs end to end, P = 1 included, and every policy trains on its own half of the slots."""
    argv = [
        "--env=grid_duel_small", "--experiment=duel_smoke", f"--train_dir={tmp_path}", "--seed=3", "--device=cpu",
        f"--num_policies={num_policies}", "--pbt_mix_policies_in_one_env=True", "--async_rl=False", "--use_rnn=True", "--rnn_size=32",
        "--encoder_conv_architecture=resnet_impala", "--encoder_conv_mlp_layers", "32", "--num_envs=8", "--rollout=8", "--recurrence=8",
        "--batch_size=64", "--num_epochs=1", "--train_for_env_steps=1024", "--experiment_summaries_interval=0",
    ]
    cfg, runner = _runner(argv)
    assert runner.mixed and runner.num_slots == 16 and runner._slot_policies.tolist() == [s % num_policies for s in range(16)]
    assert runner.run() == 0 and runner.env_steps == 1024  # 8 envs x 2 agents x 8 steps an iteration
    stats = runner.host_stats()
    assert len(stats) == num_policies
    for p in range(num_policies):
        assert stats[p]["valids_fraction"] == 1.0 / num_policies and all(np.isfinite(v) for v in stats[p].values())
        assert _summaries(os.path.join(str(tmp_path), "duel_smoke"), p)
        assert glob.glob(os.path.join(str(tmp_path), "duel_smoke", f"checkpoint_p{p}", "checkpoint_*.pth"))
    # both agents of an env finish together, so the policies count the same episodes
    counts = [es.total_episodes for es in runner.episode_stats_per_policy]
    assert len(set(counts)) == 1
    assert set(runner.sampler_state.shaping) == {"hit_reward", "hit_penalty", "win_reward"}
    assert all(v.shape == (num_policies,) for v in runner.sampler_state.shaping.values())


def test_selfplay_pbt_writes_shaping_into_the_policy_row(tmp_path):
    """Mixed mode: a mutated shaping lands in row p of the [P] tensors, the other row stays."""
    argv = [
        "--env=grid_duel_small", "--experiment=duel_pbt", f"--train_dir={tmp_path}", "--seed=3", "--device=cpu", "--num_policies=2",
        "--async_rl=False", "--use_rnn=False", "--encoder_conv_architecture=resnet_impala", "--encoder_conv_mlp_layers", "16",
        "--num_envs=4", "--rollout=8", "--batch_size=32", "--train_for_env_steps=256", "--with_pbt=True", "--pbt_start_mutation=64",
        "--pbt_period_env_steps=64", "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5",
    ]
    cfg, runner = _runner(argv, [_rigged_objective([1.0, 0.0])])
    assert runner.run() == 0
    shaping = json.load(open(os.path.join(str(tmp_path), "duel_pbt", "policy_01_reward_shaping.json")))
    for k, row in runner.sampler_state.shaping.items():
        assert row[1].item() == pytest.approx(shaping[k], rel=1e-6) and shaping[k] != runner.env.reward_shaping[k]
        assert row[0].item() == runner.env.reward_shaping[k]


def test_pbt_shaping_without_dynamic_support_is_ignored_with_a_warning(tmp_path):
    """The synthetic env has a shaping scheme but does not take it at run time: PBT still records
    the mutated values, the runner warns and drops the update (`multi_policy_runner.py:226-232`)."""
    argv = [
        "--env=synthetic_vector_discrete", "--experiment=syn_pbt", f"--train_dir={tmp_path}", "--seed=1", "--device=cpu",
        "--num_policies=2", "--num_workers=2", "--num_envs_per_worker=4", "--rollout=8", "--batch_size=32", "--use_rnn=False",
        "--encoder_mlp_layers", "16", "--train_for_env_steps=512", "--with_pbt=True", "--pbt_start_mutation=64",
        "--pbt_period_env_steps=64", "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5",
    ]
    cfg, runner = _runner(argv, [_rigged_objective([1.0, 0.0])])
    assert runner.sampler_state[0].shaping is None
    assert runner.run() == 0
    assert os.path.isfile(os.path.join(str(tmp_path), "syn_pbt", "policy_01_reward_shaping.json"))
    assert not runner.pbt.pending_shaping_updates and runner.sampler_state[1].shaping is None
    with open(os.path.join(str(tmp_path), "syn_pbt", "sf_log.txt")) as f:
        assert "no dynamic shaping support" in f.read()


def test_population_learns_with_pbt(tmp_path):
    """Counterpart of `tests/test_multi_policy.py:20-67` at its 500k steps: every policy of a
    population of 3 under aggressive PBT mutation reaches the JAX test's threshold of 1.2."""
    argv = [
        "--env=synthetic_vector_discrete", "--experiment=pbt_test", f"--train_dir={tmp_path}", "--seed=5", "--device=cpu",
        "--num_policies=3", "--num_workers=4", "--num_envs_per_worker=12", "--rollout=16", "--batch_size=128",
        "--learning_rate=3e-4", "--train_for_env_steps=500000", "--with_pbt=True", "--pbt_start_mutation=100000",
        "--pbt_period_env_steps=50000", "--pbt_mutation_rate=0.9", "--save_every_sec=5", "--experiment_summaries_interval=1",
        "--encoder_mlp_layers", "64", "64", "--use_rnn=False",
    ]
    cfg, runner = _runner(argv)
    assert runner.run() == 0
    exp = os.path.join(str(tmp_path), "pbt_test")
    for p in range(3):
        rewards = [r["train/reward"] for r in _summaries(exp, p) if "train/reward" in r]
        assert rewards and max(rewards) > 1.2, f"policy {p} did not learn: {max(rewards) if rewards else None}"
        assert glob.glob(os.path.join(exp, f"checkpoint_p{p}", "checkpoint_*")), f"no checkpoint for policy {p}"
    assert glob.glob(os.path.join(exp, "policy_*_cfg.json"))  # PBT wrote per-policy cfg files
