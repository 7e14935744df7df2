"""The NetHack example (`examples/nethack/`) against the JAX package's (`sf_examples_tpu/nethack/`).

- The flags and defaults, key for key.
- The wrappers of both packages over `FakeTtyEnv` (the synthetic tty env of
  `tests/test_nethack_integration.py`), and `make_nethack_env` of both packages over the engine
  stand-in `tests/standins/nle/` (neither machine has NLE): one seeded episode stream gives the same
  observations, rewards, ends and `episode_extra_stats`.
- Both encoders through the bridge (float32 1e-5, bfloat16 0.03) at [B] and [S, R] leading dims and
  at the cursors of the crop's edges; the JAX classes refuse the learner's [S, R, ...] observations
  (a fault of the JAX side, not copied), so the learner-shaped comparisons hold the port against
  the JAX encoder applied to the flattened batch.
- One learner update of the LSTM actor-critic under the NetHack defaults at 1e-5.
- `train_nethack.main` over the engine stand-in through worker processes, then `enjoy_nethack` and
  `fast_eval_nethack`; the card's env-level stand-in `tests/standins/nethack_standin.py` declares
  the real stack's spaces and stat keys.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

gym = pytest.importorskip("gymnasium")

from flax.errors import ScopeParamShapeError  # noqa: E402

from sample_factory_tpu.algo.context import global_model_factory as jax_global_model_factory  # noqa: E402
from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context  # noqa: E402
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs import spaces as jax_spaces  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.utils.static_cfg import StaticConfig  # noqa: E402
from sf_examples_tpu.nethack import models as jax_models  # noqa: E402
from sf_examples_tpu.nethack import nethack_env as jax_nethack_env  # noqa: E402
from sf_examples_tpu.nethack import wrappers as jax_wrappers  # noqa: E402
from sf_examples_tpu.nethack.train_nethack import parse_nethack_args as jax_parse_nethack_args  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import global_model_factory, reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.envs import spaces as torch_spaces  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import from_gym_space  # noqa: E402
from sample_factory_tpu_torch.examples.nethack import models, nethack_env, wrappers  # noqa: E402
from sample_factory_tpu_torch.examples.nethack.train_nethack import (  # noqa: E402
    nethack_encoder_factory,
    parse_nethack_args,
    register_nethack_components,
)
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402
from sample_factory_tpu_torch.models.model_utils import init_parameters_  # noqa: E402

torch.set_num_threads(1)

STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standins")  # nle/, nethack_sim.py, nethack_standin.py
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTY_ROWS, TTY_COLS = 24, 80


@pytest.fixture(autouse=True)
def _fresh_contexts():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


@pytest.fixture()
def standin_engine(monkeypatch):
    """`import nle` finds the stand-in, here and in spawned workers."""
    monkeypatch.syspath_prepend(STANDIN_DIR)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([STANDIN_DIR, os.environ.get("PYTHONPATH", "")]))
    names = ("nle", "nle.nethack", "nle.env", "nethack_sim", "nethack_standin")
    for name in names:
        monkeypatch.delitem(sys.modules, name, raising=False)
    yield
    for name in names:
        sys.modules.pop(name, None)


# ---------------------------------------------------------------- flags and wrappers


def test_flags_and_defaults_match_jax():
    """Every key of the parsed cfg equals the JAX package's, the device's default apart, for both
    models; the defaults give the LSTM-512 float32 policy of batch 1024 over rollouts of 32."""
    for model in ("ChaoticDwarvenGPT5", "ScaledNet"):
        argv = ["--env=nethack_challenge", "--experiment=e", f"--model={model}"]
        jcfg, tcfg = jax_parse_nethack_args(argv), parse_nethack_args(argv)
        assert set(jcfg) == set(tcfg)
        assert {k: tcfg[k] for k in tcfg if k != "device"} == {k: jcfg[k] for k in jcfg if k != "device"}
    assert tcfg.device == "gpu"
    assert (tcfg.use_rnn, tcfg.rnn_type, tcfg.rnn_size, tcfg.compute_dtype, tcfg.batch_size, tcfg.rollout) == (True, "lstm", 512, "float32", 1024, 32)
    assert [s.name for s in nethack_env.NETHACK_ENVS] == [s.name for s in jax_nethack_env.NETHACK_ENVS]
    assert [s.env_id for s in nethack_env.NETHACK_ENVS] == [s.env_id for s in jax_nethack_env.NETHACK_ENVS]
    assert nethack_env.OBSERVATION_KEYS == jax_nethack_env.OBSERVATION_KEYS


class FakeTtyEnv(gym.Env):
    """Synthetic NLE-shaped env (as `tests/test_nethack_integration.py`'s), with a moving cursor."""

    def __init__(self):
        self.observation_space = gym.spaces.Dict({
            "tty_chars": gym.spaces.Box(0, 255, (TTY_ROWS, TTY_COLS), np.uint8),
            "tty_colors": gym.spaces.Box(0, 31, (TTY_ROWS, TTY_COLS), np.int8),
            "tty_cursor": gym.spaces.Box(0, 255, (2,), np.uint8)})
        self.action_space = gym.spaces.Discrete(5)
        self.t = 0

    def _obs(self):
        rng = np.random.default_rng(self.t)
        cursor = [(0, 0), (12, 40), (23, 79), (22, 3), (1, 78)][self.t % 5]
        obs = {"tty_chars": rng.integers(32, 128, (TTY_ROWS, TTY_COLS)).astype(np.uint8),
               "tty_colors": rng.integers(0, 16, (TTY_ROWS, TTY_COLS)).astype(np.int8), "tty_cursor": np.array(cursor, np.uint8)}
        obs["tty_chars"][cursor] = ord("@")
        return obs

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), 0.0, self.t >= 8, False, {}


@pytest.mark.parametrize("crop,pixel", [(12, 6), (18, 6), (9, 3)])
def test_tile_tty_and_prev_actions_match_jax(crop, pixel):
    """TileTTY and PrevActionsWrapper of both packages over FakeTtyEnv (cursors at the corners and on
    the status lines): the same screen images and previous actions, step for step."""
    envs = [pkg.PrevActionsWrapper(pkg.TileTTY(FakeTtyEnv(), crop_size=crop, rescale_font_size=(pixel, pixel)))
            for pkg in (wrappers, jax_wrappers)]
    outs = [env.reset() for env in envs]
    for t in range(10):
        (tobs, _), (jobs, _) = outs
        assert tobs["screen_image"].shape == (crop * pixel, crop * pixel, 2) and tobs["screen_image"].dtype == np.uint8
        for key in jobs:
            np.testing.assert_array_equal(tobs[key], jobs[key], err_msg=f"step {t} {key}")
        outs = [env.step(t % 5)[:2] for env in envs]
    assert envs[0].observation_space == envs[1].observation_space
    arr = np.arange(24 * 80).reshape(24, 80)
    for cursor in [(0, 0), (12, 40), (23, 79), (22, 0), (1, 79)]:
        np.testing.assert_array_equal(wrappers.crop_around_cursor(np.stack([arr, arr]), cursor, 9),
                                      jax_wrappers.crop_around_cursor(np.stack([arr, arr]), cursor, 9))


def _env_cfgs(env):
    argv = [f"--env={env}", "--experiment=e"]
    return jax_parse_nethack_args(argv), parse_nethack_args(argv + ["--device=cpu"])


@pytest.mark.parametrize("env", [spec.name for spec in jax_nethack_env.NETHACK_ENVS])
def test_nethack_env_matches_jax_over_the_engine_standin(standin_engine, env):
    """make_nethack_env of both packages over the stand-in engine on each of the eight tasks
    (NoProgressTimeout, TileTTY 18 x 6, prev actions, the blstats and task-score wrappers): 400 steps of one seeded action sequence give
    the same observations, rewards, ends and infos, `episode_extra_stats` included."""
    jcfg, tcfg = _env_cfgs(env)
    jenv, tenv = jax_nethack_env.make_nethack_env(env, jcfg), nethack_env.make_nethack_env(env, tcfg)
    assert tenv.observation_space == jenv.observation_space and tenv.action_space == jenv.action_space
    assert tenv.action_space.n == 121
    (tobs, _), (jobs, _) = tenv.reset(seed=5), jenv.reset(seed=5)
    rng = np.random.default_rng(0)
    ends, stats = 0, 0
    for step in range(400):
        assert set(tobs) == set(jobs) == {"message", "blstats", "tty_chars", "tty_colors", "tty_cursor", "screen_image", "prev_actions"}
        for key in jobs:
            np.testing.assert_array_equal(tobs[key], jobs[key], err_msg=f"step {step} {key}")
        action = int(rng.integers(tenv.action_space.n))
        tout, jout = tenv.step(action), jenv.step(action)
        assert tout[1:4] == jout[1:4] and tout[4] == jout[4], f"step {step}"
        tobs, jobs = tout[0], jout[0]
        if tout[2] or tout[3]:
            ends += 1
            stats += "episode_extra_stats" in tout[4]
            (tobs, _), (jobs, _) = tenv.reset(seed=step), jenv.reset(seed=step)
    assert ends >= 2 and stats == ends
    tenv.close()
    jenv.close()


def test_nethack_env_raises_without_nle(monkeypatch):
    """Without nle the env raises on creation, as the JAX package's does; nothing falls back."""
    monkeypatch.setitem(sys.modules, "nle", None)  # `import nle` raises ImportError
    assert not nethack_env.nethack_available()
    with pytest.raises(RuntimeError, match="nle is not installed"):
        nethack_env.make_nethack_env("nethack_challenge", _env_cfgs("nethack_challenge")[1])


def test_card_standin_declares_the_real_stack_spaces(standin_engine):
    """`tests/standins/nethack_standin.py` (what the card drives, without gymnasium) has the spaces of
    nethack_challenge's real stack over the engine stand-in, as the port's specs give them, and
    reports the same `episode_extra_stats` keys; it registers the NetHack encoder factory."""
    import nethack_standin as standin

    real = nethack_env.make_nethack_env("nethack_challenge", _env_cfgs("nethack_challenge")[1])
    env = standin.make_nethack_standin("nethack_challenge", None, {"env_id": 3})
    assert env.observation_space == from_gym_space(real.observation_space)
    assert env.action_space == from_gym_space(real.action_space)
    keys = []
    for e in (env, real):
        e.reset(seed=2)
        rng = np.random.default_rng(1)
        while True:
            _, _, term, trunc, info = e.step(int(rng.integers(121)))
            if term or trunc:
                keys.append(sorted(info["episode_extra_stats"]))
                break
    assert keys[0] == keys[1] and "gold_score" in keys[0] and "score" in keys[0]
    standin.register_nethack_standin()
    assert global_model_factory().encoder_factory is nethack_encoder_factory


def test_modules_workers_import_load_no_torch():
    """`train_nethack` (the register function's module, which host-env workers import) loads no torch."""
    code = ("import sys\nimport sample_factory_tpu_torch.examples.nethack.train_nethack as t\n"
            "t.register_nethack_components()\nassert 'torch' not in sys.modules, 'torch loaded'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)


# ---------------------------------------------------------------- the encoders through the bridge

NUM_ACTIONS = 121
EDGE_CURSORS = [(0, 0), (1, 79), (21, 40), (22, 0), (23, 79), (12, 0), (0, 79), (23, 0)]


def _spaces(s):
    return s.make_dict_spec({
        "message": s.Box((256,), 0.0, 255.0, "uint8"), "blstats": s.Box((27,), -1e9, 1e9, "int64"),
        "tty_chars": s.Box((TTY_ROWS, TTY_COLS), 0.0, 255.0, "uint8"), "tty_colors": s.Box((TTY_ROWS, TTY_COLS), 0.0, 31.0, "int8"),
        "tty_cursor": s.Box((2,), 0.0, 255.0, "uint8"), "screen_image": s.Box((108, 108, 2), 0.0, 255.0, "uint8"),
        "prev_actions": s.Box((1,), 0.0, float(NUM_ACTIONS), "int32")}), s.Discrete(NUM_ACTIONS)


def _obs(rng, lead, cursors=None):
    cursor = np.stack([rng.integers(0, TTY_ROWS, lead), rng.integers(0, TTY_COLS, lead)], -1).astype(np.uint8)
    if cursors is not None:
        flat = cursor.reshape(-1, 2)
        flat[: len(cursors)] = cursors
    return {"tty_chars": rng.integers(32, 128, lead + (TTY_ROWS, TTY_COLS)).astype(np.uint8),
            "tty_colors": rng.integers(0, 16, lead + (TTY_ROWS, TTY_COLS)).astype(np.int8), "tty_cursor": cursor,
            "screen_image": rng.integers(0, 256, lead + (108, 108, 2)).astype(np.uint8),
            "prev_actions": rng.integers(0, NUM_ACTIONS, lead + (1,)).astype(np.int32),
            "message": rng.integers(0, 256, lead + (256,)).astype(np.uint8), "blstats": rng.integers(0, 100, lead + (27,)).astype(np.int64)}


def _flat_batch(cls):
    """The JAX encoder applied to the batch flattened to [N, ...] and reshaped back: the JAX classes
    take `B = tty.shape[0]`, so the learner's [S, R, ...] reaches them only so."""

    class FlatBatch(cls):
        def __call__(self, obs_dict):
            lead = obs_dict["tty_chars"].shape[:-2]
            out = super().__call__({k: v.reshape((-1,) + v.shape[len(lead):]) for k, v in obs_dict.items()})
            return out.reshape(lead + out.shape[-1:])

    return FlatBatch


NARROW = {"ChaoticDwarvenGPT5": ["--rnn_size=32"], "ScaledNet": ["--rnn_size=32", "--h_dim=48", "--fc_after_cnn_hdim=64", "--blstats_hdim=64"]}


def _models(model, dtype="float32", extra=()):
    argv = ["--env=nethack_challenge", "--experiment=e", f"--model={model}", f"--compute_dtype={dtype}", "--seed=0"] + NARROW[model] + list(extra)
    jcfg, tcfg = jax_parse_nethack_args(argv), parse_nethack_args(argv + ["--device=cpu"])
    from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic
    from sample_factory_tpu.models.model_utils import default_compute_dtype as jax_default_compute_dtype

    cls = _flat_batch(jax_models.MODELS_LOOKUP[model])
    jax_global_model_factory().register_encoder_factory(lambda cfg, space: cls(cfg, space, dtype=jax_default_compute_dtype(cfg)))
    register_nethack_components()
    jspaces, tspaces = _spaces(jax_spaces), _spaces(torch_spaces)
    return jcfg, tcfg, jax_create_actor_critic(jcfg, *jspaces), create_actor_critic(tcfg, *tspaces), jspaces, tspaces


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("model", ["ChaoticDwarvenGPT5", "ScaledNet"])
def test_jax_nethack_encoders_refuse_the_learner_batch(model):
    """The JAX classes take `B = tty.shape[0]`: at [2, 2, ...] the one-hot of the top line has 24 x
    80 x 256 inputs a row where `msg_fc0` holds 80 x 256, and flax raises; so the JAX NetHack example
    cannot run a train call. The port's encoders take any leading dims."""
    argv = ["--env=nethack_challenge", "--experiment=e", f"--model={model}"] + NARROW[model]
    enc = jax_models.make_nethack_encoder(StaticConfig(jax_parse_nethack_args(argv)), _spaces(jax_spaces)[0])
    rng = np.random.default_rng(0)
    params = enc.init(jax.random.PRNGKey(0), _j(_obs(rng, (4,))))
    with pytest.raises(ScopeParamShapeError, match="msg_fc0"):
        enc.apply(params, _j(_obs(rng, (2, 2))))
    tenc = models.make_nethack_encoder(parse_nethack_args(argv + ["--device=cpu"]), _spaces(torch_spaces)[0])
    with torch.no_grad():
        out = init_parameters_(tenc, torch.Generator().manual_seed(0))({k: torch.tensor(v) for k, v in _obs(rng, (2, 2)).items()})
    assert out.shape == (2, 2, tenc.get_out_size())


def test_crop_at_the_edges_matches_lax_dynamic_slice():
    """The crop branch's window at the cursors of every edge (rows 0, 1, 21, 22, 23 of the tty; columns
    0 and 79) equals `crop_around_cursor_jax`'s exactly: a start past the padded map is clamped and a
    negative one (the top line, row -1 once it is cut) counts from the end, as `lax.dynamic_slice`
    takes it. The numpy crop zero-pads instead; the two agree inside the map."""
    rng = np.random.default_rng(0)
    maps = rng.normal(size=(len(EDGE_CURSORS) + 2, 21, 80, 3)).astype(np.float32)
    cursors = np.array([(r - 1, c) for r, c in EDGE_CURSORS] + [(10, 40), (3, 5)], np.int32)
    want = np.asarray(jax_models.crop_around_cursor_jax(jnp.asarray(maps), jnp.asarray(cursors), 9))
    got = models.crop_around_cursor_clamped(torch.tensor(maps), torch.tensor(cursors), 9).numpy()
    np.testing.assert_array_equal(got, want)
    top = list(cursors[:, 0]).index(-1)
    # the top line's window sits at the map's bottom edge: map rows 16-20 over 4 rows of padding
    np.testing.assert_array_equal(got[top, :5, 4:], maps[top, 16:21, :5])
    assert not got[top, 5:].any()
    for b in (len(cursors) - 2, len(cursors) - 1):
        np.testing.assert_array_equal(got[b, ..., 0], wrappers.crop_around_cursor(maps[b, ..., 0], cursors[b], 9))


@pytest.mark.parametrize("model", ["ChaoticDwarvenGPT5", "ScaledNet"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.03)])
def test_nethack_encoders_match_jax_through_the_bridge(model, dtype, tol):
    """Each encoder inside the actor-critic (LSTM core): one flax parameter set carried in strictly
    (1-D conv kernels, GroupNorm scales, named embeddings among it); the head, logits, values and
    LSTM state of a rollout step ([B], the cursors of the crop's edges) and the head of a learner
    batch ([S, R]) equal JAX's."""
    _, _, jmodel, tmodel, _, _ = _models(model, dtype)
    assert isinstance(tmodel.encoder, models.MODELS_LOOKUP[model])
    rng = np.random.default_rng(0)
    obs = _obs(rng, (len(EDGE_CURSORS),), EDGE_CURSORS)
    rnn = rng.normal(size=(len(EDGE_CURSORS), 64)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), _j(obs), jnp.asarray(rnn))
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    jhead = jmodel.apply(params, _j(obs), method="forward_head")
    jlogits, jvalues, jstate = jmodel.apply(params, _j(obs), jnp.asarray(rnn))
    batch = _obs(rng, (2, 3), EDGE_CURSORS[:6])
    jbatch = jmodel.apply(params, _j(batch), method="forward_head")
    with torch.no_grad():
        tobs = {k: torch.tensor(v) for k, v in obs.items()}
        thead = tmodel.forward_head(tobs)
        tlogits, tvalues, tstate = tmodel(tobs, torch.tensor(rnn))
        tbatch = tmodel.forward_head({k: torch.tensor(v) for k, v in batch.items()})
    for got, want in ((thead, jhead), (tlogits, jlogits), (tvalues, jvalues), (tstate, jstate), (tbatch, jbatch)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("model", ["ChaoticDwarvenGPT5", "ScaledNet"])
def test_bridge_round_trip_of_the_nethack_models(model):
    """flax -> torch -> flax: every leaf comes back unchanged (the 1-D kernels as [K, I, O], GroupNorm
    `scale`, the named embeddings' `embedding`)."""
    _, _, jmodel, tmodel, _, _ = _models(model)
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), _j(_obs(rng, (2,))), jnp.zeros((2, 64))))
    bridge.load_flax_params(tmodel, params)
    sd = tmodel.state_dict()
    back = dict(jax.tree_util.tree_leaves_with_path(bridge.state_dict_to_flax(sd, tmodel)))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back) == len(sd)
    for path, value in flat:
        np.testing.assert_array_equal(back[path], value)
    enc = params["params"]["encoder"]
    assert enc["bottomline"]["conv0"]["kernel"].shape == (8, 2, 32)
    if model == "ScaledNet":
        assert "scale" in enc["crop_norm0"] and "embedding" in enc["screen"]["char_embeddings"]


T, N = 8, 4


@pytest.mark.parametrize("model", ["ChaoticDwarvenGPT5", "ScaledNet"])
def test_one_update_under_nethack_params_matches_jax(model):
    """One train call of each package from one parameter set on one trajectory with episode ends: the
    NetHack defaults (LSTM over segments of 8, no input normalization, normalized returns, reward clip
    10, one epoch of one minibatch). JAX runs its encoder on the flattened batch. Parameters, the
    returns normalizer and the learning rate after it: 1e-5."""
    argv = [f"--rollout={T}", f"--recurrence={T}", f"--batch_size={T * N}", f"--num_envs={N}"]
    jcfg, tcfg, jmodel, tmodel, jspaces, tspaces = _models(model, extra=argv)
    assert (tcfg.rnn_type, tcfg.num_epochs, tcfg.num_batches_per_epoch, tcfg.normalize_input, tcfg.normalize_returns) == ("lstm", 1, 1, False, True)
    jinfo = JaxEnvInfo(obs_space=jspaces[0], action_space=jspaces[1], num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=tspaces[0], action_space=tspaces[1], num_agents=1, is_device_env=False)
    tx = jax_make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), _j(_obs(rng, (2,))))
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    traj = {
        "obs": _obs(rng, (T + 1, N), EDGE_CURSORS),
        "rnn_states": rng.normal(size=(T + 1, N, 64)).astype(np.float32) * 0.5,
        "actions": rng.integers(0, NUM_ACTIONS, size=(T, N, 1)).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, NUM_ACTIONS)).astype(np.float32) * 0.1,
        "log_prob_actions": np.log(rng.uniform(0.005, 0.02, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32) * 5,
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "time_outs": np.zeros((T, N), np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jts2, _ = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 1 and np.isfinite(float(tstats["loss"]))
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(tts.returns_rms.running_mean.numpy(), np.asarray(jts2.returns_rms.running_mean), atol=1e-5)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)


# ---------------------------------------------------------------- the example end to end


def test_train_nethack_through_worker_processes_then_enjoy_and_fast_eval(standin_engine, tmp_path):
    """`train_nethack.main` on nethack_challenge at the NetHack defaults (async with the quantized
    learner, ChaoticDwarvenGPT5, LSTM) over the engine stand-in, cut to 2 workers x 2 envs, rollouts of
    8 and a narrow LSTM: it trains and writes a checkpoint; `enjoy_nethack.main` plays it back and
    `fast_eval_nethack.main` writes its CSV."""
    from sample_factory_tpu_torch.examples.nethack import enjoy_nethack, fast_eval_nethack, train_nethack

    argv = ["--env=nethack_challenge", "--experiment=nh", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=2",
            "--num_envs_per_worker=2", "--worker_num_splits=2", "--rollout=8", "--recurrence=8", "--batch_size=32",
            "--rnn_size=32", "--train_for_env_steps=256", "--decorrelate_envs_on_one_worker=False"]
    assert train_nethack.main(argv) == 0
    assert glob.glob(os.path.join(str(tmp_path), "nh", "checkpoint_p0", "checkpoint_*.pth"))
    assert enjoy_nethack.main(argv + ["--no_render", "--max_num_episodes=2"]) == 0
    assert fast_eval_nethack.main(argv + ["--sample_env_episodes=4", "--num_workers=1", "--num_envs_per_worker=2"]) == 0
    assert glob.glob(os.path.join(str(tmp_path), "nh", "eval", "*.csv"))
