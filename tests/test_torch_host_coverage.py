"""Counterparts of three JAX-side host-path tests that the port had none of:

- `tests/test_extra_stats.py`: an env's `episode_extra_stats` reach the runner's episodic-stats
  handlers once an episode, with the policy id (0 in a population, as in the JAX runner), and
  `AlgoObserver.extra_summaries` is called;
- `tests/test_tuple_action_envs.py`: tuple actions (two Discrete; Discrete + Box) trained end
  to end through worker processes, with the export round trip on the tuple head;
- `tests/test_async_overlap.py` (`medium`): on an env that sleeps 14 ms a step, the learner's
  quanta go out inside the rollouts and async beats sync.

The envs and their register functions live at module level and import neither JAX nor the
JAX package, so that the spawned env workers can import this module.
"""

import glob
import json
import time
from os.path import join

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.envs.env_utils import register_env
from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args
from sample_factory_tpu_torch.runner.runner import AlgoObserver

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    yield
    reset_global_context()


# ------------------------------------------------------------ custom episode stats


class ExtraStatsEnv(gym.Env):
    """Tiny episodic env that reports a custom per-episode stat in the final info."""

    def __init__(self):
        self.observation_space = gym.spaces.Box(-1, 1, (4,), np.float32)
        self.action_space = gym.spaces.Discrete(2)
        self.t = 0
        self.episodes = 0

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return self.observation_space.sample(), {}

    def step(self, action):
        self.t += 1
        done = self.t >= 9
        info = {}
        if done:
            self.episodes += 1
            info["episode_extra_stats"] = {"z_00_custom_raw_score": float(self.episodes), "z_00_custom_len": self.t}
        return self.observation_space.sample(), 1.0, done, False, info


def register_extra_stats_env():
    register_env("extra_stats_env", lambda _name, _cfg, _env_config, render_mode=None: ExtraStatsEnv())


class CollectingObserver(AlgoObserver):
    def __init__(self):
        self.summaries_calls = 0

    def extra_summaries(self, runner, policy_id, writer, env_steps):
        self.summaries_calls += 1
        writer.add_scalar("_custom/marker", 1.0, env_steps)


@pytest.mark.parametrize("num_policies", [1, 2])
def test_extra_stats_flow(tmp_path, num_policies):
    """tests/test_extra_stats.py through the port's HostEnvRunner (1 policy) and
    HostMultiPolicyRunner (2 policies: every episode goes to policy 0, as in the JAX runner)."""
    from sample_factory_tpu_torch.train import make_rl_runner

    argv = [
        "--env=extra_stats_env", "--experiment=extras", f"--train_dir={tmp_path}", "--seed=3", "--device=cpu",
        "--num_workers=1", "--num_envs_per_worker=4", "--worker_num_splits=1", "--rollout=16", "--batch_size=64",
        "--train_for_env_steps=640", "--serial_mode=True", "--use_rnn=False", "--experiment_summaries_interval=0",
        f"--num_policies={num_policies}", "--encoder_mlp_layers", "16",
    ]
    register_extra_stats_env()
    _, runner = make_rl_runner(parse_gym_args(argv), register_fn=register_extra_stats_env)
    assert type(runner).__name__ == ("HostEnvRunner" if num_policies == 1 else "HostMultiPolicyRunner")
    seen = []
    runner.register_episodic_stats_handler(lambda r, extras, pid: seen.append((dict(extras), pid)))
    observer = CollectingObserver()
    runner.register_observer(observer)
    runner.init()
    assert runner.run() == 0

    # 640 steps / 9-step episodes across 4 envs: dozens of completed episodes
    assert len(seen) >= 10, f"extra stats did not flow: {len(seen)}"
    extras, pid = seen[0]
    assert pid == 0 and all(p == 0 for _, p in seen)
    assert "z_00_custom_raw_score" in extras and extras["z_00_custom_len"] == 9
    assert observer.summaries_calls >= 1, "AlgoObserver.extra_summaries never invoked"
    assert runner.policy_avg_stats == {}  # the base class holds it for observers and PBT


# ------------------------------------------------------------------- tuple actions


class IdentityEnvTwoDiscrete(gym.Env):
    """One-hot state; reward 1 per tuple component that identifies the state."""

    def __init__(self, size=4):
        self.size = size
        self.observation_space = gym.spaces.Box(-1, 1, shape=(size,), dtype=np.float32)
        self.action_space = gym.spaces.Tuple([gym.spaces.Discrete(size), gym.spaces.Discrete(size * 3)])
        self.ep_length = 10
        self._rng = np.random.default_rng(0)
        self.current_step = 0

    def _next_state(self):
        self.state = np.zeros(self.size, np.float32)
        self.index = int(self._rng.integers(self.size))
        self.state[self.index] = 1.0

    def reset(self, seed=None, **kwargs):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.current_step = 0
        self._next_state()
        return self.state, {}

    def step(self, action):
        assert isinstance(action[0], (int, np.integer)) and isinstance(action[1], (int, np.integer))
        r = float(self.index == action[0]) + float(self.index * 3 == self.size * 3 - action[1] - 1)
        self._next_state()
        self.current_step += 1
        return self.state, r, self.current_step >= self.ep_length, False, {}


class IdentityEnvMixed(IdentityEnvTwoDiscrete):
    """Mixed tuple: a Discrete identifying the state + a Box regressing it."""

    def __init__(self, size=4):
        super().__init__(size)
        self.action_space = gym.spaces.Tuple([gym.spaces.Discrete(size), gym.spaces.Box(-1.0, 1.0, (1,), dtype=np.float32)])

    def step(self, action):
        assert isinstance(action[0], (int, np.integer))
        cont = np.asarray(action[1], np.float32)
        assert cont.shape == (1,)
        target = 2.0 * self.index / (self.size - 1) - 1.0
        r = float(self.index == action[0]) + max(0.0, 1.0 - 2.0 * abs(float(cont[0]) - target))
        self._next_state()
        self.current_step += 1
        return self.state, r, self.current_step >= self.ep_length, False, {}


TUPLE_ENVS = {"tuple_two_discrete": IdentityEnvTwoDiscrete, "tuple_mixed": IdentityEnvMixed}


def _make_tuple_env(name, cfg=None, env_config=None, render_mode=None):
    return TUPLE_ENVS[name](4)


def register_tuple_envs():
    for name in TUPLE_ENVS:
        register_env(name, _make_tuple_env)


@pytest.mark.parametrize(
    "env_name,batched",
    [
        ("tuple_two_discrete", True),
        ("tuple_mixed", False),
        pytest.param("tuple_mixed", True, marks=pytest.mark.medium),
        pytest.param("tuple_two_discrete", False, marks=pytest.mark.medium),
    ],
    ids=["batched-tuple_two_discrete", "non_batched-tuple_mixed", "batched-tuple_mixed", "non_batched-tuple_two_discrete"],
)
def test_tuple_actions_e2e(tmp_path, env_name, batched):
    """tests/test_tuple_action_envs.py at its sizes and threshold; the export round trip of
    :147-160 on the mixed tuple head (here in both of its cases)."""
    from sample_factory_tpu_torch.export_model import export_model, load_exported_model
    from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state
    from sample_factory_tpu_torch.train import run_rl

    register_tuple_envs()
    argv = [
        f"--env={env_name}", "--experiment=tup", f"--train_dir={tmp_path}", "--seed=0", "--device=cpu",
        f"--batched_sampling={batched}", "--num_workers=2", "--num_envs_per_worker=8", "--worker_num_splits=2",
        "--rollout=16", "--batch_size=512", "--use_rnn=False", "--encoder_mlp_layers", "64", "64", "--nonlinearity=tanh",
        "--decorrelate_envs_on_one_worker=False", "--train_for_env_steps=90000", "--experiment_summaries_interval=2",
        "--save_every_sec=5",
    ]
    assert run_rl(parse_gym_args(argv), register_fn=register_tuple_envs) == 0

    (jsonl,) = glob.glob(join(str(tmp_path), "tup", ".summary", "0", "summaries.jsonl"))
    with open(jsonl) as f:
        rewards = [d["train/reward"] for d in map(json.loads, f) if "train/reward" in d]
    # random play ~3.3 (two-discrete) / ~8 (mixed) per 10-step episode
    assert max(rewards) > rewards[0] + 3.0, f"did not learn: {rewards[0]} -> {max(rewards)}"

    if env_name == "tuple_mixed":
        eval_cfg = parse_gym_args(argv + ["--eval_deterministic=True"], evaluation=True)
        exported = load_exported_model(export_model(eval_cfg, batch_size=2, register_fn=register_tuple_envs))
        with torch.no_grad():
            actions, _ = exported({"obs": torch.zeros((2, 4))}, initial_actor_critic_state(eval_cfg, 2))
        assert actions.shape == (2, 2)  # 1 discrete + 1 box component


# ------------------------------------------------------------------------ overlap


class SleepEnv(gym.Env):
    observation_space = gym.spaces.Box(-1, 1, (24,), np.float32)
    action_space = gym.spaces.Discrete(2)

    def __init__(self):
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros(24, np.float32), {}

    def step(self, a):
        time.sleep(0.014)
        self.t += 1
        return np.random.randn(24).astype(np.float32), 1.0, self.t >= 1000, False, {}


def register_sleep_env():
    register_env("sleep_env", lambda name, cfg, env_config, render_mode=None: SleepEnv())


class _IterTimer(AlgoObserver):
    def __init__(self, n_iters: int):
        self.times = []
        self.n = n_iters

    def on_training_iteration(self, runner, stats) -> None:
        self.times.append(time.perf_counter())
        if len(self.times) >= self.n:
            runner.stop()


def _run_mode(tmp_path, async_rl: str, n_iters: int = 12):
    from sample_factory_tpu_torch.runner.host_runner import HostEnvRunner

    argv = [
        "--env=sleep_env", f"--experiment=overlap_{async_rl}", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=2",
        "--num_envs_per_worker=8", "--worker_num_splits=2", "--rollout=16", "--batch_size=256", "--num_epochs=24",
        "--encoder_mlp_layers", "1024", "1024", "1024", "--use_rnn=False", "--train_for_env_steps=999999999",
        f"--async_rl={async_rl}", "--seed=1", "--experiment_summaries_interval=10000", "--save_every_sec=10000",
        "--decorrelate_envs_on_one_worker=False",
    ]
    runner = HostEnvRunner(parse_gym_args(argv), register_fn=register_sleep_env)
    runner.init()
    timer = _IterTimer(n_iters)
    runner.register_observer(timer)
    runner.run()
    return float(np.median(np.diff(timer.times)[4:])), runner


@pytest.mark.medium
def test_async_overlaps_training_with_env_stepping(tmp_path):
    """tests/test_async_overlap.py: at least 80% of the learner's quanta go out inside the
    rollouts, async beats sync by 1.10x, and the trajectories carry the lag of the sgd steps
    that ran."""
    register_sleep_env()
    sync_iter, _ = _run_mode(tmp_path, "False")
    async_iter, async_runner = _run_mode(tmp_path, "True")
    q = async_runner._quantizer
    overlap_frac = 1.0 - q.quanta_drained_at_flush / max(1, q.total_quanta_enqueued)
    speedup = sync_iter / async_iter
    print(f"sync {sync_iter * 1e3:.0f} ms/iter, async {async_iter * 1e3:.0f} ms/iter, speedup {speedup:.2f}x, "
          f"overlap_frac {overlap_frac:.3f}")
    assert overlap_frac >= 0.80, f"{q.quanta_drained_at_flush}/{q.total_quanta_enqueued} quanta drained at flush"
    assert speedup >= 1.10, f"sync={sync_iter:.3f}s async={async_iter:.3f}s speedup={speedup:.2f}x (< 1.10x)"
    stats = async_runner.host_stats()
    executed = q.last_sgd_steps_executed
    assert executed >= 2 * q.num_minibatches  # the first two epochs always run
    assert stats["version_diff_max"] >= executed
