"""The host-env path of the port end to end on the CPU: `run_rl` on CartPole (sync and
async, serial and with worker processes), resume, `enjoy`, `eval` and `SyncSamplingAPI`, the
mixed-policy rollout against the JAX sampler's, `HostMultiPolicyRunner` on the 2-agent matching
game with PBT, and the dispatch in `train.py`.

The learning runs carry the JAX test's threshold at its step count
(`tests/test_host_env_training.py`: CartPole reward above 100 by 120k steps) and its `medium`
marker; a short run of each regime stays in tier-1.
"""

import functools
import glob
import json
import os
import random
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

gym = pytest.importorskip("gymnasium")

from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context
from sample_factory_tpu.algo.host_sampling import HostVectorSampler as JaxHostVectorSampler
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer
from sample_factory_tpu.envs.env_info import obtain_env_info as jax_obtain_env_info
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
from sample_factory_tpu_torch import bridge
from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import TRAJECTORY_KEYS
from sample_factory_tpu_torch.algo.sampling_api import EvalSamplingAPI, SyncSamplingAPI
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.examples import train_custom_multi_env as game
from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args, register_gym_env
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.train import make_rl_runner, run_rl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


def _cartpole_cfg(tmp_path, experiment, extra=(), steps=120_000):
    """The configuration of `tests/test_host_env_training.py:_cfg`."""
    argv = [
        "--env=CartPole-v1", f"--experiment={experiment}", f"--train_dir={tmp_path}", "--seed=11", "--device=cpu",
        "--num_workers=2", "--num_envs_per_worker=8", "--worker_num_splits=2", "--rollout=32", "--batch_size=256",
        "--learning_rate=3e-4", f"--train_for_env_steps={steps}", "--save_every_sec=5", "--experiment_summaries_interval=2",
        "--encoder_mlp_layers", "64", "64", "--use_rnn=False",
    ] + list(extra)
    return parse_gym_args(argv)


def _register_cartpole():
    register_fn = functools.partial(register_gym_env, "CartPole-v1")
    register_fn()
    return register_fn


def _rewards_written(tmp_path, experiment):
    path = glob.glob(os.path.join(str(tmp_path), experiment, ".summary", "0", "summaries.jsonl"))[0]
    with open(path) as f:
        return [d["train/reward"] for d in map(json.loads, f) if "train/reward" in d]


@pytest.mark.medium
@pytest.mark.parametrize(
    "extra", [["--serial_mode=True", "--async_rl=False"], ["--serial_mode=False", "--async_rl=True"]], ids=["serial_sync", "parallel_async"]
)
def test_cartpole_learns(tmp_path, extra):
    experiment = f"cartpole_{extra[0][-4:]}"
    cfg = _cartpole_cfg(tmp_path, experiment, extra)
    assert run_rl(cfg, register_fn=_register_cartpole()) == 0
    rewards = _rewards_written(tmp_path, experiment)
    assert rewards, "no reward summaries written"
    # CartPole random ~20; must have learned substantially by 120k steps
    assert max(rewards) > 100, f"did not learn: max reward {max(rewards)}"


@pytest.mark.parametrize("async_rl", [False, True], ids=["sync", "async"])
def test_run_rl_on_cartpole_in_serial_mode_and_resume(tmp_path, async_rl):
    """Three iterations of each regime, then a resume for two more: env steps, policy version
    and parameters carry over, and the async regime overlapped its learner with the rollouts."""
    extra = ["--serial_mode=True", f"--async_rl={async_rl}", "--num_epochs=2"]
    per_iter, sgd = 16 * 32, 2 * 2  # 512 transitions in 2 minibatches of 256, 2 epochs
    register_fn = _register_cartpole()
    _, runner = make_rl_runner(_cartpole_cfg(tmp_path, "short", extra, steps=3 * per_iter), register_fn=register_fn)
    assert type(runner).__name__ == "HostEnvRunner"
    runner.init()
    assert runner.sampler.transport == "serial" and (runner._quantizer is not None) == async_rl
    assert runner.run() == 0
    assert runner.env_steps == 3 * per_iter and runner.train_state.train_step == 3 * sgd
    stats = runner.host_stats()
    assert stats and all(np.isfinite(v) for v in stats.values()) and stats["grad_norm"] > 0
    assert runner.episode_stats.total_episodes > 0 and 5 < runner.episode_stats.avg_reward < 200
    if async_rl:
        q = runner._quantizer
        assert q.total_quanta_enqueued == 3 * (1 + 2 * 3)
        # train steps 1 and 2 went out inside rollouts 2 and 3; the last one at the final flush
        assert q.quanta_drained_at_flush == 1 + 2 * 3
        # collected by the snapshot from before the previous train step, read at the end of its own
        assert stats["version_diff_max"] == 2 * sgd
    else:
        assert stats["version_diff_max"] == sgd
    exp = tmp_path / "short"
    assert (exp / "config.json").is_file() and (exp / "done").read_text() == str(3 * per_iter)
    assert [c.name for c in sorted((exp / "checkpoint_p0").glob("checkpoint_*.pth"))][-1] == f"checkpoint_{3 * sgd:012d}_{3 * per_iter}.pth"
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(f"sftpu_{os.getpid()}_")]

    _, resumed = make_rl_runner(_cartpole_cfg(tmp_path, "short", extra, steps=5 * per_iter), register_fn=register_fn)
    resumed.init()
    try:
        assert resumed.env_steps == 3 * per_iter and resumed.train_state.train_step == 3 * sgd
        assert resumed._version_host == resumed._behavior_version_host == 3 * sgd
        torch.testing.assert_close(resumed.train_state.model.state_dict(), runner.train_state.model.state_dict())
    except BaseException:
        resumed._release_resources()
        raise
    assert resumed.run() == 0
    assert resumed.env_steps == 5 * per_iter and resumed.train_state.train_step == 5 * sgd


def test_enjoy_eval_and_sampling_api_on_a_host_env(tmp_path):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.eval import do_eval

    register_fn = _register_cartpole()
    train_cfg = _cartpole_cfg(tmp_path, "api_host", ["--serial_mode=True", "--num_envs_per_worker=4", "--rollout=8", "--batch_size=64"], steps=128)
    assert run_rl(train_cfg, register_fn=register_fn) == 0

    def eval_cfg(*extra):
        return parse_gym_args(["--env=CartPole-v1", "--experiment=api_host", f"--train_dir={tmp_path}", *extra], evaluation=True)

    episodes = []
    status, avg_reward = enjoy(eval_cfg("--no_render", "--max_num_episodes=3"), collect_episodes=episodes)
    assert status == 0 and len(episodes) == 3 and avg_reward == pytest.approx(np.mean([r for r, _ in episodes]))
    assert all(r == n >= 5 for r, n in episodes)  # CartPole pays 1 a step
    # --save_video renders rgb_array frames into the experiment's replay video
    assert enjoy(eval_cfg("--save_video", "--max_num_episodes=1", "--video_frames=16"))[0] == 0
    assert (tmp_path / "api_host" / "replay.mp4").stat().st_size > 0

    assert do_eval(eval_cfg("--sample_env_episodes=12"), register_fn=register_fn) == 0
    rows = (tmp_path / "api_host" / "eval" / "eval_p0.csv").read_text().strip().splitlines()
    assert rows[0] == "episode,reward,length" and len(rows) == 13

    # the library API (tests/test_sampling_api.py:65-93): shapes, then episodes from the checkpoint
    api = SyncSamplingAPI(train_cfg, register_fn=register_fn)
    api.start()
    try:
        traj = api.get_trajectories_sync()
        assert set(traj) == set(TRAJECTORY_KEYS)
        assert traj["rewards"].shape == (8, 8) and traj["obs"]["obs"].shape == (9, 8, 4)
    finally:
        api.stop()
    evaluator = EvalSamplingAPI(train_cfg, register_fn=register_fn)
    evaluator.start()
    try:
        assert evaluator.train_state.train_step == 2  # the checkpoint's
        sampled = evaluator.sample_episodes(5)
        assert len(sampled) == 5 and all(r == n for r, n in sampled)
    finally:
        evaluator.stop()


# ------------------------------------------------------------ the mixed-policy rollout against JAX


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bias_action(params, action_idx: int, scale: float = 50.0):
    def edit(path, leaf):
        names = [str(getattr(p, "key", getattr(p, "name", ""))) for p in path]
        if any("action_parameterization" in n for n in names) and names[-1] == "bias":
            return jnp.zeros_like(leaf).at[action_idx].set(scale)
        return leaf

    return jax.tree_util.tree_map_with_path(edit, params)


GAME_ARGV = [
    "--serial_mode=True", "--num_workers=2", "--num_envs_per_worker=4", "--worker_num_splits=2", "--rollout=12",
    "--use_rnn=True", "--rnn_size=16", "--encoder_mlp_layers", "16", "--normalize_input=True", "--seed=4", "--device=cpu",
    "--num_policies=2", "--custom_env_episode_len=5", "--batch_size=96",
]


def test_mixed_policy_rollout_matches_jax_value_for_value():
    """The matching game, 2 agents an env, policies mixed inside every env: policy 0 always
    plays 0 and policy 1 always plays 1, so every active agent is paid the penalty; all agents
    are inactive for their first 2 steps (`policy_id` -1). The port runs each policy on its own
    slots where the JAX sampler runs both on all and selects (`_policy_step_multi`): every key
    of the trajectory agrees, floats 1e-5. The game draws its deactivations from Python's global
    generator, seeded alike before each side."""
    from sf_examples_tpu import train_custom_multi_env as jax_game

    jax_game.register_custom_components()
    game.register_custom_components()
    jcfg, tcfg = jax_game.parse_custom_args([f"--env={game.ENV_NAME}", *GAME_ARGV]), game.parse_custom_args([f"--env={game.ENV_NAME}", *GAME_ARGV])
    jinfo, tinfo = jax_obtain_env_info(jcfg), obtain_env_info(tcfg)
    assert tinfo.num_agents == jinfo.num_agents == 2 and tinfo.reward_shaping_scheme == jinfo.reward_shaping_scheme == {"rew": -1.0}
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    jstates, tstates = [], []
    for p in range(2):
        jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(10 + p), {"obs": jnp.zeros((2, 8))})
        jts = jts.replace(params=_bias_action(jts.params, p))
        mean, var = rng.uniform(0.3, 0.7, 8).astype(np.float32), rng.uniform(0.05, 0.2, 8).astype(np.float32)
        jts = jts.replace(obs_rms={"obs": jts.obs_rms["obs"].replace(running_mean=jnp.asarray(mean), running_var=jnp.asarray(var))})
        tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
        bridge.load_flax_params(tmodel, _np_tree(jts.params))
        tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
        tts.obs_rms = {"obs": replace(tts.obs_rms["obs"], running_mean=torch.tensor(mean), running_var=torch.tensor(var))}
        jstates.append(jts)
        tstates.append(tts)
    stacked = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731

    random.seed(123)
    jsampler = JaxHostVectorSampler(jcfg, jinfo, jmodel)
    jsampler.start()
    random.seed(123)
    tsampler = HostVectorSampler(tcfg, tinfo, "cpu")
    tsampler.start()
    try:
        K, split_size, N, T = 2, 8, 16, 12
        assert tsampler.num_envs == jsampler.num_envs == N and tsampler.split_size == split_size
        slot_policies = (np.arange(N) % 2).astype(np.int32).reshape(K, split_size)
        slot_policies[1, :2] = [1, 1]  # one env whose agents share a policy: they match and earn 0
        versions = [7, 9]
        for rollout in range(2):
            random.seed(50 + rollout)
            jtraj, jstats = jsampler.collect_rollout(stacked([s.params for s in jstates]), stacked([s.obs_rms for s in jstates]),
                                                     jax.random.PRNGKey(rollout), np.asarray(versions, np.int32), slot_policies=slot_policies)
            random.seed(50 + rollout)
            ttraj, tstats = tsampler.collect_rollout([s.model for s in tstates], [s.obs_rms for s in tstates], versions, slot_policies=slot_policies)
            assert set(ttraj) == set(jtraj) == set(TRAJECTORY_KEYS)
            for key in TRAJECTORY_KEYS:
                t, j = (ttraj[key]["obs"], jtraj[key]["obs"]) if key == "obs" else (ttraj[key], jtraj[key])
                j = np.asarray(j)
                assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype), key
                if np.issubdtype(j.dtype, np.integer):
                    np.testing.assert_array_equal(t.numpy(), j, err_msg=key)
                else:
                    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0, err_msg=key)
            flat = torch.tensor(slot_policies.reshape(-1))
            assert (ttraj["actions"][..., 0] == flat[None]).all()
            active = ttraj["policy_id"] >= 0
            assert (ttraj["policy_id"][active] == flat[None].expand(T, N)[active]).all()
            assert (ttraj["policy_version"] == torch.tensor(versions)[flat.long()][None]).all()
            if rollout == 0:
                assert not active[:2].any() and active[2:].all()  # every agent sits out its first 2 steps
            mismatched = torch.ones(N, dtype=torch.bool)
            mismatched[8:10] = False
            # an active agent of a mismatched pair is paid the penalty, an inactive one nothing
            assert (ttraj["rewards"][:, mismatched][active[:, mismatched]] == -1.0).all()
            assert (ttraj["rewards"][:, mismatched][~active[:, mismatched]] == 0).all() and (ttraj["rewards"][:, ~mismatched] == 0).all()
            assert tstats["count"] == jstats["count"] == 2 * N and tstats["return_sum"] == pytest.approx(jstats["return_sum"])
            # episodes of 5 steps end for both agents of an env at once; every slot finished 2
            assert sorted(tstats["slots"]) == sorted(list(range(N)) * 2)
    finally:
        jsampler.close()
        tsampler.close()


# ------------------------------------------------------------ the multi-policy host runner


def _game_runner(tmp_path, experiment, extra=()):
    game.register_custom_components()
    argv = [f"--env={game.ENV_NAME}", f"--experiment={experiment}", f"--train_dir={tmp_path}", "--serial_mode=True", "--device=cpu",
            "--num_policies=2", "--num_workers=2", "--num_envs_per_worker=4", "--worker_num_splits=2", "--rollout=16",
            "--batch_size=128", "--encoder_mlp_layers", "16", "--custom_env_episode_len=4", "--seed=5",
            "--save_every_sec=100000", "--experiment_summaries_interval=100000", *extra]
    cfg, runner = make_rl_runner(game.parse_custom_args(argv), register_fn=game.register_custom_components)
    assert type(runner).__name__ == "HostMultiPolicyRunner"
    assert cfg.num_envs == 2 * 4 * 2  # agent slots: workers x envs x agents
    return cfg, runner


def test_host_multi_policy_runner_with_pbt_on_the_matching_game(tmp_path):
    """Async (the default), policies mixed inside the envs, 5 iterations of 256 agent steps, PBT
    due once, after iteration 3 (384 agent steps a policy), with policy 1 the worst."""
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    per_iter = 16 * 16
    cfg, runner = _game_runner(tmp_path, "duel", [
        "--pbt_mix_policies_in_one_env=True", "--with_pbt=True", f"--pbt_start_mutation={3 * per_iter // 2}", f"--pbt_period_env_steps={3 * per_iter // 2}",
        "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5", "--pbt_replace_reward_gap=0.0", "--pbt_replace_reward_gap_absolute=0.0",
        f"--train_for_env_steps={5 * per_iter}"])
    seen = []

    class Watch(AlgoObserver):
        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[1.0], [0.0]]
            collect = runner.sampler.collect_rollout

            def recording_collect(models, obs_rms, versions, **kwargs):
                traj, stats = collect(models, obs_rms, versions, **kwargs)
                seen.append({"traj": traj, "slot_policies": kwargs["slot_policies"].copy(), "versions": list(versions),
                             "behaviour": models is runner.behavior_models})
                return traj, stats

            runner.sampler.collect_rollout = recording_collect

        def on_stop(self, runner):
            # serial mode: the envs live in this process; a policy's shaping sits on its own agents
            self.shaping = [[env.reward_shaping for env in row] for st in runner.sampler.serial_steppers for row in st.envs]

    watch = Watch()
    runner.register_observer(watch)
    runner.init()
    assert runner.sampler.num_envs == 16 and runner.slot_policies.shape == (2, 8)
    assert runner.run() == 0
    assert runner.env_steps == 5 * per_iter and len(seen) == 5

    # rollouts ran the snapshots, one train call behind (2 sgd steps a call: 256 x 2 / 128... one epoch of 2 minibatches)
    assert all(r["behaviour"] for r in seen)
    assert [r["versions"][0] for r in seen[:3]] == [0, 0, 2]
    for r in seen:
        flat = torch.tensor(r["slot_policies"].reshape(-1))
        pid = r["traj"]["policy_id"]
        assert ((pid == flat[None]) | (pid == -1)).all() and (pid == -1).any() and (pid >= 0).any()
    # the async mapping was drawn anew (10 episodes an env: 128 agent-episodes an iteration against 80)
    assert runner.mapping_resamples >= 2
    assert any(not np.array_equal(a["slot_policies"], b["slot_policies"]) for a, b in zip(seen, seen[1:]))
    # each policy trained on its own share of the active steps (the exploit copy moved policy 1's
    # version past --max_policy_lag, which masks what its stale snapshot collected, rollout 4; rollout 5 is whole again)
    stats = runner.host_stats()
    assert len(stats) == 2 and all(0.1 < s["valids_fraction"] < 0.9 and np.isfinite(s["loss"]) for s in stats)
    assert sum(s["valids_fraction"] for s in stats) <= 1.0 + 1e-6

    # PBT: policy 1's files, and its mutated shaping on exactly the agents it drove at that time
    exp = tmp_path / "duel"
    with open(exp / "policy_01_reward_shaping.json") as f:
        shaping = json.load(f)
    assert shaping != {"rew": -1.0} and (exp / "policy_01_cfg.json").is_file()
    on_agents = [s for env_rows in watch.shaping for env in env_rows for s in env]
    assert any(s == shaping for s in on_agents) and any(s == {"rew": -1.0} for s in on_agents)
    assert not runner.pbt.pending_shaping_updates
    for p in range(2):
        assert list((exp / f"checkpoint_p{p}").glob("checkpoint_*.pth"))
    # episodes: 16 slots x 4 episodes an iteration, each credited to one policy
    totals = [es.total_episodes for es in runner.episode_stats_per_policy]
    assert sum(totals) == 5 * 16 * 4 and all(t > 0 for t in totals)


def test_episodes_are_credited_to_the_policy_of_their_slot(tmp_path):
    """The JAX runner gives every policy the same share of the aggregate window
    (`host_multi_policy_runner.py:268-270`); the port credits an episode to the policy that
    drove its slot, so that PBT compares what each policy earned."""
    cfg, runner = _game_runner(tmp_path, "credit", ["--async_rl=False", "--train_for_env_steps=512"])
    runner.init()
    try:
        assert runner.behavior_models is None  # sync: the live parameters
        runner.slot_policies = np.asarray([[0, 0, 0, 0, 0, 0, 1, 1], [1, 1, 1, 1, 1, 1, 0, 0]], np.int32)
        ep_stats = {"count": 4.0, "return_sum": -10.0, "len_sum": 16.0,
                    "episodes": [(-1.0, 4), (-2.0, 4), (-3.0, 4), (-4.0, 4)], "slots": [0, 6, 8, 15]}
        runner._process_stats([{}, {}], ep_stats)
        p0, p1 = runner.episode_stats_per_policy
        assert p0.total_episodes == 2 and p0.avg_reward == pytest.approx(-2.5)  # slots 0 and 15
        assert p1.total_episodes == 2 and p1.avg_reward == pytest.approx(-2.5)  # slots 6 and 8
        runner._process_stats([{}, {}], {"count": 1.0, "return_sum": -8.0, "len_sum": 4.0, "episodes": [(-8.0, 4)], "slots": [7]})
        assert p0.total_episodes == 2 and p1.total_episodes == 3
        assert runner.run() == 0  # and the sync regime trains: 2 iterations of 256 agent steps
        assert runner.env_steps == 512 and all(ts.train_step == 4 for ts in runner.train_state)
    finally:
        runner._release_resources()


# ------------------------------------------------------------ dispatch


@pytest.mark.parametrize("env,policies,want", [
    ("synthetic_vector_discrete", 1, "Runner"), ("synthetic_vector_discrete", 2, "MultiPolicyRunner"),
    ("batched_cartpole", 1, "HostEnvRunner"), ("batched_cartpole", 2, "HostMultiPolicyRunner"),
])
def test_train_dispatches_every_combination(tmp_path, env, policies, want):
    from sample_factory_tpu_torch.envs.batched_host_env import register_batched_cartpole
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    register_batched_cartpole()
    cfg = parse_custom_args([f"--env={env}", f"--num_policies={policies}", "--device=cpu", f"--train_dir={tmp_path}", "--experiment=d",
                             "--serial_mode=True", "--num_workers=2", "--num_envs_per_worker=4", "--rollout=8", "--batch_size=32",
                             "--train_for_env_steps=128"])
    cfg, runner = make_rl_runner(cfg, register_fn=register_batched_cartpole)
    assert type(runner).__name__ == want
    runner.init()
    assert runner.run() == 0 and runner.env_steps == 128


# ------------------------------------------------------------ the pettingzoo adapter, the env-info cache


def _make_rps(full_env_name, cfg=None, env_config=None, render_mode=None):
    from sample_factory_tpu_torch.envs.pettingzoo_adapter import make_pettingzoo_env

    return make_pettingzoo_env("pettingzoo.classic.rps_v2", parallel=False)


def _register_rps():
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env("pz_rps", _make_rps)


def test_pettingzoo_adapter_contract_and_a_short_self_play_run(tmp_path):
    """`tests/test_pettingzoo.py`'s contract on the port's copy of the adapter, then
    rock-paper-scissors through the host multi-policy runner for a few iterations."""
    pytest.importorskip("pettingzoo")
    env = _make_rps("pz_rps")
    assert env.num_agents == 2 and env.is_multiagent
    obs, infos = env.reset(seed=1)
    assert len(obs) == 2 and obs[0].shape == (4,)
    obs, rewards, terms, truncs, infos = env.step([0, 1])
    assert rewards == [-1.0, 1.0] and all(i["is_active"] for i in infos)  # rock loses to paper
    env.close()

    _register_rps()
    cfg = parse_gym_args(["--env=pz_rps", "--experiment=rps", f"--train_dir={tmp_path}", "--seed=1", "--device=cpu", "--num_policies=2",
                          "--serial_mode=True", "--async_rl=False", "--num_workers=2", "--num_envs_per_worker=4", "--rollout=16",
                          "--batch_size=128", "--train_for_env_steps=768", "--encoder_mlp_layers", "32", "--use_rnn=False"])
    cfg, runner = make_rl_runner(cfg, register_fn=_register_rps)
    assert type(runner).__name__ == "HostMultiPolicyRunner" and cfg.num_envs == 16
    runner.init()
    assert runner.env_info.obs_space["obs"].shape == (4,) and runner.env_info.action_space.n == 3
    assert runner.run() == 0 and runner.env_steps == 768
    assert sum(es.total_episodes for es in runner.episode_stats_per_policy) > 0


def test_env_info_cache_is_written_under_the_train_dir_and_read_back(tmp_path):
    from sample_factory_tpu_torch.envs import env_info as env_info_module

    _register_cartpole()
    cfg = _cartpole_cfg(tmp_path, "cache", ["--serial_mode=True", "--use_env_info_cache=True"])
    first = obtain_env_info(cfg)
    cached = list((tmp_path / ".env_info_cache").glob("CartPole-v1_*.pkl"))
    assert len(cached) == 1
    reset_global_context()  # the env is no longer registered: only the cache can answer
    second = obtain_env_info(cfg)
    assert second == first and second.obs_space["obs"].shape == (4,) and not second.is_device_env
    cfg.env_frameskip = 4  # another fingerprint: the stale entry is not used
    with pytest.raises(KeyError, match="not registered"):
        obtain_env_info(cfg)
    assert env_info_module.ENV_INFO_PROTOCOL_VERSION == first.env_info_protocol_version
