"""The Atari examples (`examples/atari/`, `examples/envpool/`) against the JAX package's
(`sf_examples_tpu/atari/`, `sf_examples_tpu/envpool/`).

- `make_atari_env` of both packages over a fake ALE game registered with gymnasium (ale_py is not
  installed here): the whole DeepMind wrapper stack in its order, one seed, one action sequence,
  observations, rewards, terminations and truncations equal over 200 steps.
- The 57-game registry and the error without ale_py, value for value.
- The envpool adapter of both packages over the fake pool of `tests/test_envpool_atari.py`: task id,
  the CHW -> HWC transpose, the auto-reset fix, Montezuma's timeout divided by 4; then the port's
  adapter over the stand-in pool of `tests/standins/` (spaces in the port's own specs, as on the card's
  machine) in a training run through worker processes.
- One learner update under `atari_params` (convnet_atari + Dense 512 over 84x84x4 uint8,
  obs_scale 255, normalized inputs and returns, 4 epochs of 1 or 2 minibatches, linear decay,
  adam_eps 1e-5) at a cut number of envs and steps, JAX (compiled at XLA's default level) against
  the port from one parameter set: 1e-5.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

gym = pytest.importorskip("gymnasium")

from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.envs.spaces import Box as JBox, Discrete as JDiscrete, make_dict_spec as jax_dict_spec  # noqa: E402
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic  # noqa: E402
from sample_factory_tpu.utils.attr_dict import AttrDict as JaxAttrDict  # noqa: E402
from sf_examples_tpu.atari import atari_utils as jax_atari_utils  # noqa: E402
from sf_examples_tpu.atari.train_atari import parse_atari_args as jax_parse_atari_args  # noqa: E402
from sf_examples_tpu.envpool import train_envpool_atari as jax_envpool_atari  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec  # noqa: E402
from sample_factory_tpu_torch.examples.atari import atari_utils  # noqa: E402
from sample_factory_tpu_torch.examples.atari.train_atari import parse_atari_args  # noqa: E402
from sample_factory_tpu_torch.examples.envpool import train_envpool_atari as envpool_atari  # noqa: E402
from sample_factory_tpu_torch.utils.attr_dict import AttrDict  # noqa: E402

torch.set_num_threads(1)

STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standins")  # envpool.py, as on the card's machine


class _FakeALE:
    def __init__(self):
        self._lives = 3

    def lives(self):
        return self._lives


class FakeAtariGame(gym.Env):
    """Scripted ALE stand-in, as in tests/test_atari_wrappers.py: 210x160x3 frames that vary with
    the step and the pixel, FIRE required, 3 lives, a life lost every 13 steps."""

    observation_space = gym.spaces.Box(0, 255, (210, 160, 3), dtype=np.uint8)
    action_space = gym.spaces.Discrete(4)
    _pattern = (np.arange(210)[:, None, None] * 3 + np.arange(160)[None, :, None] * 5 + np.arange(3) * 60).astype(np.int64)

    def __init__(self, render_mode=None):
        self.ale = _FakeALE()
        self.t = 0

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def _obs(self):
        return ((self._pattern + 11 * self.t) % 256).astype(np.uint8)

    def reset(self, seed=None, options=None):
        super().reset(seed=seed)
        self.t = 0
        self.ale._lives = 3
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        reward = 3.7 if action == 2 else (-2.0 if action == 3 else 0.0)
        if self.t % 13 == 0:
            self.ale._lives -= 1
        return self._obs(), reward, self.ale._lives <= 0, False, {}


GAMES = {"BreakoutNoFrameskip-v4": 30, "MontezumaRevengeNoFrameskip-v4": 30}  # id -> TimeLimit of the fake, in frames


@pytest.fixture()
def fake_ale(monkeypatch):
    monkeypatch.setitem(sys.modules, "ale_py", types.ModuleType("ale_py"))
    for env_id, limit in GAMES.items():
        gym.register(env_id, entry_point=FakeAtariGame, max_episode_steps=limit)
    yield
    for env_id in GAMES:
        gym.registry.pop(env_id)


@pytest.mark.parametrize("game,actions", [("atari_breakout", "mixed"), ("atari_montezuma", "noop")])
def test_wrapper_stack_matches_jax(fake_ale, game, actions):
    """make_atari_env of both packages, each over its own fake game: frameskip 4 with max-pool,
    no-ops from the env's seeded generator, FIRE on reset, life loss as termination, clipped
    rewards, 84x84 grayscale, a stack of 4 (HWC). Breakout's episodes end by life loss and by the
    fake's 30-frame TimeLimit; Montezuma's 18000-frame timeout replaces that limit, so its episodes
    end by life loss only."""
    cfg = type("C", (), {"env_frameskip": 4, "env_framestack": 4})()
    jenv = jax_atari_utils.make_atari_env(game, cfg)
    tenv = atari_utils.make_atari_env(game, cfg)
    assert tenv.observation_space.shape == (84, 84, 4) and tenv.observation_space.dtype == np.uint8
    (jobs, _), (tobs, _) = jenv.reset(seed=5), tenv.reset(seed=5)
    np.testing.assert_array_equal(tobs, jobs)
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, 200) if actions == "mixed" else np.zeros(200, np.int64)
    ends = {"terminated": 0, "truncated": 0}
    rewards = set()
    for a in seq:
        jout, tout = jenv.step(int(a)), tenv.step(int(a))
        np.testing.assert_array_equal(tout[0], jout[0])
        assert tout[1:4] == jout[1:4]
        rewards.add(tout[1])
        ends["terminated"] += int(tout[2])
        ends["truncated"] += int(tout[3])
        if tout[2] or tout[3]:
            (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
            np.testing.assert_array_equal(tobs, jobs)
    assert ends["terminated"] > 0
    if actions == "mixed":
        assert rewards == {-1.0, 0.0, 1.0} and ends["truncated"] > 0
    else:
        assert ends["truncated"] == 0 and tenv.spec.max_episode_steps == 18000


def test_registry_and_missing_ale(monkeypatch):
    assert [(s.name, s.env_id, s.default_timeout) for s in atari_utils.ATARI_ENVS] == [
        (s.name, s.env_id, s.default_timeout) for s in jax_atari_utils.ATARI_ENVS]
    assert len(atari_utils.ATARI_ENVS) == 57
    assert atari_utils.atari_env_by_name("atari_breakout").env_id == "BreakoutNoFrameskip-v4"
    with pytest.raises(ValueError, match="Unknown Atari env"):
        atari_utils.atari_env_by_name("atari_notagame")
    monkeypatch.setitem(sys.modules, "ale_py", None)
    assert not atari_utils.atari_available() and not jax_atari_utils.atari_available()
    for make in (atari_utils.make_atari_env, jax_atari_utils.make_atari_env):
        with pytest.raises(RuntimeError, match="Atari requires ale_py"):
            make("atari_breakout")
    assert [(s.name, s.env_id, s.default_timeout) for s in envpool_atari.ENVPOOL_ATARI_ENVS] == [
        (s.name, s.env_id, s.default_timeout) for s in jax_envpool_atari.ENVPOOL_ATARI_ENVS]


def test_atari_params_match_jax():
    argv = ["--env=atari_breakout", "--device=cpu"]
    jcfg, tcfg = jax_parse_atari_args(argv), parse_atari_args(argv)
    for key in ("encoder_conv_architecture", "obs_scale", "env_frameskip", "env_framestack", "num_workers", "rollout", "batch_size",
                "num_epochs", "num_batches_per_epoch", "learning_rate", "lr_schedule", "adam_eps", "ppo_clip_ratio", "max_grad_norm",
                "normalize_input", "normalize_returns", "async_rl", "use_rnn", "exploration_loss_coeff", "gae_lambda"):
        assert tcfg[key] == jcfg[key], key
    assert tcfg.encoder_conv_architecture == "convnet_atari" and not tcfg.async_rl and not tcfg.use_rnn


class FakeAtariPool:
    """The fake pool of tests/test_envpool_atari.py: gymnasium spaces, CHW frames that encode each
    env's step counter, the terminal frame at done, reset(env_ids)."""

    def __init__(self, num_envs, max_episode_steps=8):
        self.num_envs = num_envs
        self.observation_space = gym.spaces.Box(0, 255, (4, 84, 84), dtype=np.uint8)
        self.action_space = gym.spaces.Discrete(6)
        self.t = np.zeros(num_envs, np.int64)
        self.limit = max_episode_steps

    def _obs(self):
        return np.broadcast_to((self.t % 256).astype(np.uint8)[:, None, None, None], (self.num_envs, 4, 84, 84)).copy()

    def reset(self, env_ids=None):
        ids = slice(None) if env_ids is None else np.asarray(env_ids)
        self.t[ids] = 0
        return self._obs()[ids], {}

    def step(self, actions):
        self.t += 1
        return self._obs(), np.where(actions == 1, 1.0, 0.0).astype(np.float32), self.t >= self.limit, np.zeros(self.num_envs, bool), {}

    def close(self):
        pass


@pytest.fixture()
def fake_envpool(monkeypatch):
    made = []
    fake = types.ModuleType("envpool")

    def make(task_id, env_type, num_envs, seed, **kwargs):
        assert env_type == "gymnasium"
        made.append({"task_id": task_id, "seed": seed, "kwargs": kwargs})
        return FakeAtariPool(num_envs, max_episode_steps=kwargs.get("max_episode_steps", 8))

    fake.make = make
    monkeypatch.setitem(sys.modules, "envpool", fake)
    return made


def test_envpool_adapter_matches_jax(fake_envpool):
    split = {"num_envs": 3, "env_id": 2}
    cfg = {"seed": 7, "env_seed_offset": 100, "num_envs_per_worker": 6, "worker_num_splits": 2}
    jenv = jax_envpool_atari.make_envpool_atari_env("envpool_atari_pong", JaxAttrDict(cfg), JaxAttrDict(split))
    tenv = envpool_atari.make_envpool_atari_env("envpool_atari_pong", AttrDict(cfg), AttrDict(split))
    assert fake_envpool[0] == fake_envpool[1] == {"task_id": "Pong-v5", "seed": 109, "kwargs": {}}
    assert tenv.observation_space == Box((84, 84, 4), 0.0, 255.0, "uint8")
    assert tuple(jenv.observation_space.shape) == (84, 84, 4)
    (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
    np.testing.assert_array_equal(tobs, jobs)
    assert tobs.shape == (3, 84, 84, 4)
    for step in range(1, 20):
        actions = np.full(3, step % 2)
        jout, tout = jenv.step(actions), tenv.step(actions)
        for j, t in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(t, j)
        # at done the next episode's first frame (0), not the terminal one (8)
        assert (tout[0] == step % 8).all()
    envpool_atari.make_envpool_atari_env("envpool_atari_montezuma", None, AttrDict(split))
    assert fake_envpool[-1]["kwargs"] == {"max_episode_steps": 18000 // 4}
    with pytest.raises(ValueError, match="Unknown envpool atari env"):
        envpool_atari.envpool_atari_env_by_name("envpool_atari_notagame")


def test_envpool_training_through_worker_processes(tmp_path, monkeypatch):
    """The envpool example at its own defaults (atari_params: sync PPO, convnet_atari + Dense 512,
    normalize_input and returns), cut to 2 workers x 8 envs in 2 splits and a short rollout, over
    the stand-in pool of `tests/standins/envpool.py`: the workers import it from the path, as on the card's machine."""
    from sample_factory_tpu_torch.train import make_rl_runner

    monkeypatch.syspath_prepend(STANDIN_DIR)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([STANDIN_DIR, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.delitem(sys.modules, "envpool", raising=False)
    reset_global_context()
    envpool_atari.register_envpool_atari_components()
    argv = ["--env=envpool_atari_breakout", "--experiment=ep", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=2",
            "--num_envs_per_worker=8", "--worker_num_splits=2", "--rollout=16", "--batch_size=64", "--train_for_env_steps=2048",
            "--encoder_conv_mlp_layers", "64", "--seed=0", "--decorrelate_envs_on_one_worker=False"]
    cfg, runner = make_rl_runner(envpool_atari.parse_envpool_atari_args(argv), register_fn=envpool_atari.register_envpool_atari_components)
    runner.init()
    try:
        assert runner.sampler.transport == "shm_queue" and len(runner.sampler.workers) == 2
        assert runner.env_info.obs_space["obs"] == Box((84, 84, 4), 0.0, 255.0, "uint8")
        lrs = []
        train = runner._train_fn

        def recording_train(ts, traj, *args, **kwargs):
            assert traj["obs"]["obs"].dtype == torch.uint8 and tuple(traj["obs"]["obs"].shape) == (17, 16, 84, 84, 4)
            out = train(ts, traj, *args, **kwargs)
            lrs.append(ts.curr_lr)
            return out

        runner._train_fn = recording_train
        assert runner.run() == 0
    finally:
        reset_global_context()
    assert runner.env_steps == 2 * 16 * 16 * 4 and len(lrs) == 2  # frames: summaries_use_frameskip with frameskip 4
    assert cfg.learning_rate > lrs[0] > lrs[1]
    assert all(np.isfinite(v) for v in runner.host_stats().values())


T, N = 16, 4
OBS = (84, 84, 4)


# XLA:CPU's own default level; the tests compile at level 1 (tests/conftest.py), under which the
# 2-minibatch update lands 4.9e-5 from the port's (at level 3: within 1e-5)
JAX_DEFAULT_OPT_LEVEL = {"xla_backend_optimization_level": 3}


@pytest.mark.parametrize("minibatches", [1, 2])
def test_one_update_under_atari_params_matches_jax(minibatches):
    """One train call of each package from one parameter set on one uint8 trajectory with
    episode ends inside it, the rollout cut into 1 or 2 minibatches trained for up to 4 epochs:
    parameters, normalizers and the learning rate after it, 1e-5. JAX's update is compiled at
    XLA's default optimisation level."""
    argv = ["--env=atari_breakout", "--device=cpu", f"--rollout={T}", f"--batch_size={T * N // minibatches}", f"--num_envs={N}",
            "--seed=0", "--train_for_env_steps=4096"]
    jcfg, tcfg = jax_parse_atari_args(argv), parse_atari_args(argv)
    assert tcfg.num_epochs == 4 and tcfg.obs_scale == 255.0 and tcfg.adam_eps == 1e-5 and tcfg.normalize_returns
    jinfo = JaxEnvInfo(obs_space=jax_dict_spec({"obs": JBox(OBS, 0.0, 255.0, "uint8")}), action_space=JDiscrete(6), num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=make_dict_spec({"obs": Box(OBS, 0.0, 255.0, "uint8")}), action_space=Discrete(6), num_agents=1, is_device_env=False)
    jmodel = jax_create_actor_critic(jcfg, jinfo.obs_space, jinfo.action_space)
    tx = jax_make_optimizer(jcfg)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), {"obs": jnp.zeros((2,) + OBS, jnp.uint8)})
    from sample_factory_tpu_torch.models.actor_critic import create_actor_critic

    tmodel = create_actor_critic(tcfg, tinfo.obs_space, tinfo.action_space)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")

    rng = np.random.default_rng(0)
    dones = (rng.random((T, N)) < 0.1).astype(np.float32)
    traj = {
        "obs": {"obs": rng.integers(0, 256, (T + 1, N) + OBS).astype(np.uint8)},
        "rnn_states": np.zeros((T + 1, N, 1), np.float32),
        "actions": rng.integers(0, 6, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, 6)).astype(np.float32) * 0.1,
        "log_prob_actions": np.log(rng.uniform(0.12, 0.22, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": np.sign(rng.normal(size=(T, N))).astype(np.float32),
        "dones": dones,
        "time_outs": np.zeros((T, N), np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jargs = (jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx)).lower(*jargs).compile(compiler_options=JAX_DEFAULT_OPT_LEVEL)(*jargs)
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) and float(tstats["epochs_executed"]) == float(jstats["epochs_executed"])
    assert tts.train_step == minibatches * float(tstats["epochs_executed"]) >= 2 * minibatches
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr)) and tts.curr_lr < tcfg.learning_rate
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    jrms, trms = jts2.obs_rms["obs"], tts.obs_rms["obs"]
    np.testing.assert_allclose(trms.running_mean.numpy(), np.asarray(jrms.running_mean), atol=1e-6)
    np.testing.assert_allclose(trms.running_var.numpy(), np.asarray(jrms.running_var), atol=1e-6)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)
