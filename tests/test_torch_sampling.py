"""The port's on-device sampler against the JAX package's: the same trajectory schema
(keys, shapes, dtypes, T+1 obs/rnn entries) and the same bookkeeping rules (the rnn
state reset where an episode ended, episodic sums, version/id stamps)."""

import numpy as np
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


@pytest.mark.parametrize("env_name,width,dtype", [("synthetic_tuple", 3, torch.float32), ("synthetic_continuous", 2, torch.float32),
                                                  ("synthetic_masked", 1, torch.int32)])
def test_rollout_action_tensors_of_other_spaces(env_name, width, dtype):
    """Tuple actions are stored as one float32 vector (the discrete part cast), Box actions as
    float32, and a masked env never sees its masked action."""
    from sample_factory_tpu_torch.envs.builtin.synthetic import make_synthetic_env

    tcfg = default_cfg(env="e", argv=["--use_rnn=False", "--encoder_mlp_layers", "16", f"--rollout={T}", f"--num_envs={N}", "--device=cpu", "--seed=0"])
    env = make_synthetic_env(env_name)
    info = extract_env_info(env, tcfg)
    model = create_actor_critic(tcfg, info.obs_space, info.action_space, torch.Generator().manual_seed(0))
    ss = init_sampler_state(tcfg, env, N, "cpu", torch.Generator().manual_seed(1))
    _, traj, _ = make_rollout_fn(tcfg, env, info)(model, None, ss, 0, 0)
    assert traj["actions"].shape == (T, N, width) and traj["actions"].dtype == dtype
    assert torch.isfinite(traj["log_prob_actions"]).all() and traj["rnn_states"].shape == (T + 1, N, 1)
    if env_name == "synthetic_tuple":
        assert set(traj["actions"][..., 0].unique().tolist()) <= {0.0, 1.0, 2.0}
    if env_name == "synthetic_masked":
        mask = traj["obs"]["action_mask"][:T]
        assert (mask[..., -1] == 0).any() and bool(torch.gather(mask, -1, traj["actions"].long()).all())


# ------------------------------------------------------------ the sampling API (device envs)


def _api_cfg(env, tmp_path, extra=()):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    return parse_custom_args([
        f"--env={env}", "--experiment=api_test", f"--train_dir={tmp_path}", "--seed=4", "--device=cpu", "--num_workers=2",
        "--num_envs_per_worker=8", "--rollout=8", "--batch_size=64", "--use_rnn=False", "--encoder_mlp_layers", "32", *extra,
    ])


def test_sync_sampling_api_device_env(tmp_path):
    """Counterpart of `tests/test_sampling_api.py:37-49`."""
    from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI

    api = SyncSamplingAPI(_api_cfg("synthetic_vector_discrete", tmp_path))
    api.start()
    traj = api.get_trajectories_sync()
    assert traj["rewards"].shape == (8, 16)
    assert traj["obs"]["obs"].shape == (9, 16, 8)  # T+1
    assert traj["actions"].shape == (8, 16, 1)
    assert int(traj["policy_version"].max()) == 0
    # the second batch continues from the same env state
    traj2 = api.get_trajectories_sync()
    assert torch.equal(traj2["obs"]["obs"][0], traj["obs"]["obs"][-1])
    assert not torch.allclose(traj["obs"]["obs"], traj2["obs"]["obs"])
    # 16-step episodes: the second rollout closes one in every env
    assert api._last_ep_stats["count"] == 16.0 and api._last_ep_stats["len_sum"] == 256.0
    api.stop()


def test_sampling_api_masked_env_actions_respect_mask(tmp_path):
    """Counterpart of `tests/test_sampling_api.py:52-62`."""
    from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI

    api = SyncSamplingAPI(_api_cfg("synthetic_masked", tmp_path))
    api.start()
    traj = api.get_trajectories_sync()
    taken = torch.gather(traj["obs"]["action_mask"][:-1], -1, traj["actions"].long())[..., 0]
    assert (traj["obs"]["action_mask"][:-1, :, -1] == 0).any() and (taken > 0).all(), "sampled a masked action"
    api.stop()


def test_sampling_api_uses_a_given_or_checkpointed_train_state(tmp_path):
    """`start(train_state)`, `set_train_state`, and the evaluation sampler, which loads the
    checkpoint of `--policy_index` and returns per-episode (return, length) pairs."""
    from sample_factory_tpu_torch.algo.sampling_api import EvalSamplingAPI, SyncSamplingAPI
    from sample_factory_tpu_torch.train import run_rl

    cfg = _api_cfg("synthetic_vector_discrete", tmp_path, ["--train_for_env_steps=1024", "--async_rl=False"])
    assert run_rl(cfg) == 0
    evaluator = EvalSamplingAPI(cfg)
    evaluator.start()
    assert evaluator.train_state.train_step == 16  # 8 iterations x 2 minibatches, from the checkpoint
    episodes = evaluator.sample_episodes(20)
    assert len(episodes) == 20 and evaluator.episodic == episodes and all(n == 16 and np.isfinite(r) for r, n in episodes)

    api = SyncSamplingAPI(cfg)
    api.start(train_state=evaluator.train_state)
    assert api.train_state is evaluator.train_state
    assert int(api.get_trajectories_sync()["policy_version"].min()) == 16
    fresh = SyncSamplingAPI(cfg)
    fresh.start()
    assert fresh.train_state.train_step == 0
    fresh.set_train_state(evaluator.train_state)
    assert int(fresh.get_trajectories_sync()["policy_version"].max()) == 16


def test_simplified_sampling_api_example(tmp_path, monkeypatch):
    """`examples/sampler/use_simplified_sampling_api.py` against the JAX example: without ALE both
    fall back to the synthetic envs; the sample count of a trajectory is T x N either way; the
    example's `main` collects at least `--sample_env_steps` and stops its sampler."""
    import sys

    from sf_examples_tpu.sampler import use_simplified_sampling_api as jax_example
    from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI
    from sample_factory_tpu_torch.examples.sampler import use_simplified_sampling_api as example
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    monkeypatch.setitem(sys.modules, "ale_py", None)
    parse, register = example._components()
    assert (parse, register) == (parse_custom_args, register_synthetic_components)
    assert jax_example._components()[1].__module__ == "sf_examples_tpu.train_synthetic"

    traj = {"obs": {"obs": np.zeros((9, 16, 8), np.float32)}, "rewards": np.zeros((8, 16), np.float32),
            "actions": np.zeros((8, 16, 1), np.int32)}
    assert example._samples_per_trajectory({k: torch.tensor(v) if k != "obs" else {"obs": torch.tensor(v["obs"])} for k, v in traj.items()}) \
        == jax_example._samples_per_trajectory({"actions": traj["actions"], "rewards": traj["rewards"]}) == 128

    calls = []
    sync = SyncSamplingAPI.get_trajectories_sync
    stops = []
    stop = SyncSamplingAPI.stop

    def recording_sync(self):
        out = sync(self)
        calls.append((tuple(out["rewards"].shape), str(out["rewards"].device)))
        return out

    def recording_stop(self):
        stops.append(self)
        return stop(self)

    monkeypatch.setattr(SyncSamplingAPI, "get_trajectories_sync", recording_sync)
    monkeypatch.setattr(SyncSamplingAPI, "stop", recording_stop)
    monkeypatch.setattr(sys, "argv", ["use_simplified_sampling_api", "--env=synthetic_vector_discrete", "--experiment=sampler",
                                      f"--train_dir={tmp_path}", "--device=cpu", "--num_envs=32", "--rollout=16", "--seed=0",
                                      "--sample_env_steps=2000"])
    assert example.main() == 0
    assert calls == [((16, 32), "cpu")] * 4 and len(stops) == 1  # 4 x 512 >= 2000
