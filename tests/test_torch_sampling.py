"""The port's on-device sampler against the JAX package's: the same trajectory schema
(keys, shapes, dtypes, T+1 obs/rnn entries) and the same bookkeeping rules (the rnn
state reset where an episode ended, episodic sums, version/id stamps)."""

import pytest
import torch

import jax

from sample_factory_tpu.algo.sampling import init_sampler_state as jax_init_sampler_state
from sample_factory_tpu.algo.sampling import make_rollout_fn as jax_make_rollout_fn
from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg
from sample_factory_tpu.envs.builtin.grid_battle import GridBattleEnv as JaxGridBattleEnv
from sample_factory_tpu.envs.env_info import extract_env_info as jax_extract_env_info
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch.algo.running_mean_std import obs_rms_init
from sample_factory_tpu_torch.algo.sampling import TRAJECTORY_KEYS, init_sampler_state, make_rollout_fn
from sample_factory_tpu_torch.cfg.arguments import default_cfg
from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv
from sample_factory_tpu_torch.envs.env_info import extract_env_info
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic

torch.set_num_threads(1)

ENV_ARGS = (24, 8, 7, 6)  # 7-step episodes: truncations and auto-resets within a rollout
N, T = 6, 10


def _cfgs(rnn_type):
    argv = [
        f"--rnn_type={rnn_type}", "--rnn_size=16", "--encoder_conv_mlp_layers", "16",
        "--encoder_conv_architecture=convnet_impala", f"--rollout={T}", f"--num_envs={N}", "--seed=0",
        "--reward_scale=0.5",
    ]
    return jax_default_cfg(env="e", argv=argv), default_cfg(env="e", argv=argv + ["--device=cpu"])


def _port_rollout(tcfg, version=3, pid=0):
    env = GridBattleEnv(*ENV_ARGS)
    info = extract_env_info(env, tcfg)
    model = create_actor_critic(tcfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    ss = init_sampler_state(tcfg, env, N, "cpu", gen)
    rollout = make_rollout_fn(tcfg, env, info)
    return rollout(model, obs_rms_init(info.obs_space), ss, version, pid)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_trajectory_schema_matches_jax(rnn_type):
    jcfg, tcfg = _cfgs(rnn_type)
    jenv = JaxGridBattleEnv(*ENV_ARGS)
    jinfo = jax_extract_env_info(jenv, jcfg)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    jss = jax_init_sampler_state(jcfg, jenv, jax.random.PRNGKey(0), N)
    params = jmodel.init(jax.random.PRNGKey(1), jss.obs, jss.rnn_state)
    _, jtraj, jep = jax_make_rollout_fn(jcfg, jenv, jinfo, jmodel)(params, None, jss, 3, 0)
    _, ttraj, tep = _port_rollout(tcfg)

    assert set(ttraj) == set(jtraj) == set(TRAJECTORY_KEYS)
    assert set(tep) == set(jep)
    for key in TRAJECTORY_KEYS:
        j, t = (jtraj[key]["obs"], ttraj[key]["obs"]) if key == "obs" else (jtraj[key], ttraj[key])
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
    assert ttraj["obs"]["obs"].shape[0] == ttraj["rnn_states"].shape[0] == T + 1


def test_rollout_bookkeeping():
    _, tcfg = _cfgs("gru")
    ss, traj, ep = _port_rollout(tcfg, version=3, pid=0)
    dones = traj["dones"]
    assert dones.sum() > 0 and traj["time_outs"].sum() > 0  # both kinds of episode end occur
    # the rnn state entering step t+1 is zero exactly where the episode ended at t
    ended = dones > 0
    assert torch.all(traj["rnn_states"][1:][ended] == 0)
    assert torch.all(traj["rnn_states"][1:][~ended].abs().sum(-1) > 0)
    assert torch.all(traj["time_outs"] <= dones)
    assert float(ep["count"]) == float(dones.sum())
    # rewards are scaled by --reward_scale before the sums; raw sums are not
    assert torch.allclose(ep["return_sum"] * 2.0, ep["raw_return_sum"]) or float(ep["count"]) == 0
    assert torch.all(traj["policy_version"] == 3) and torch.all(traj["policy_id"] == 0)
    assert traj["actions"].dtype == torch.int32 and traj["actions"].shape == (T, N, 1)
    # the sampler state carries the last obs and rnn state: the T+1 entries
    assert torch.equal(traj["obs"]["obs"][-1], ss.obs["obs"]) and torch.equal(traj["rnn_states"][-1], ss.rnn_state)
