"""The ViZDoom example (`examples/vizdoom/`) against the JAX package's (`sf_examples_tpu/vizdoom/`).

- A counterpart of each test of `tests/test_vizdoom_integration.py`, named after it, on the port's
  modules (action flattening, the spec registry, the info-driven wrappers, the generic wrappers
  the stack relies on, the encoder, the flags, the render and human-play helpers).
- Both packages' `make_doom_env` over the stand-in engine of `tests/standins/vizdoom/` (neither
  machine has vizdoom): one seed, one action sequence, the same observations, measurements,
  rewards, dones and infos for 200 steps across episode ends, for `doom_basic`, `doom_battle` and
  `doom_duel_bots`; a 2-player `doom_duel` match for 50 steps.
- The host stack repeats a Doom env's actions once in the port (the engine's frameskip), four
  times more in the JAX package (a fault of the JAX side, not copied).
- `tests/standins/doom_battle_standin.py`, which the card drives, declares the real stack's spaces.
- `VizdoomEncoder` through the bridge (float32 1e-5, bfloat16 0.03), the flax tree back out
  unchanged, one learner update under `doom_params` with GRU at 1e-5, and a JAX checkpoint of the
  example restored in the port.
- `train_vizdoom.main` over the stand-in engine through worker processes, then `enjoy_vizdoom.main`.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

gym = pytest.importorskip("gymnasium")
from gymnasium.spaces import Box as GymBox, Discrete as GymDiscrete  # noqa: E402

from sample_factory_tpu.algo.context import reset_global_context as jax_reset_global_context  # noqa: E402
from sample_factory_tpu.algo.learning import init_train_state as jax_init_train_state  # noqa: E402
from sample_factory_tpu.algo.learning import make_train_fn as jax_make_train_fn  # noqa: E402
from sample_factory_tpu.algo.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from sample_factory_tpu.envs.env_info import EnvInfo as JaxEnvInfo  # noqa: E402
from sample_factory_tpu.envs.gym_wrappers import wrap_host_env as jax_wrap_host_env  # noqa: E402
from sample_factory_tpu.envs.spaces import from_gym_space as jax_from_gym_space  # noqa: E402
from sample_factory_tpu.models.actor_critic import create_actor_critic as jax_create_actor_critic  # noqa: E402
from sample_factory_tpu.runner.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from sf_examples_tpu.vizdoom import doom_utils as jax_doom_utils  # noqa: E402
from sf_examples_tpu.vizdoom.doom import wrappers as jax_wrappers  # noqa: E402
from sf_examples_tpu.vizdoom.train_vizdoom import parse_vizdoom_cfg as jax_parse_vizdoom_cfg  # noqa: E402
from sample_factory_tpu_torch import bridge  # noqa: E402
from sample_factory_tpu_torch.algo.context import global_model_factory, reset_global_context  # noqa: E402
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn  # noqa: E402
from sample_factory_tpu_torch.algo.sampling import normalize_obs  # noqa: E402
from sample_factory_tpu_torch.envs.env_info import EnvInfo  # noqa: E402
from sample_factory_tpu_torch.envs.gym_wrappers import ResizeWrapper, RewardScalingWrapper, TimeLimitWrapper, wrap_host_env  # noqa: E402
from sample_factory_tpu_torch.envs.spaces import from_gym_space  # noqa: E402
from sample_factory_tpu_torch.examples.custom_encoders import VizdoomEncoder  # noqa: E402
from sample_factory_tpu_torch.examples.vizdoom import doom_utils  # noqa: E402
from sample_factory_tpu_torch.examples.vizdoom.doom.action_space import (  # noqa: E402
    Discretized,
    doom_action_space,
    doom_action_space_basic,
    doom_action_space_discretized_no_weap,
    doom_action_space_full_discretized,
    flatten_doom_action,
)
from sample_factory_tpu_torch.examples.vizdoom.doom.wrappers import (  # noqa: E402
    REWARD_SHAPING_BATTLE,
    REWARD_SHAPING_DEATHMATCH_V0,
    REWARD_SHAPING_DEATHMATCH_V1,
    DoomAdditionalInput,
    DoomGatheringRewardShaping,
    DoomRewardShapingWrapper,
    MultiplayerStatsWrapper,
    true_objective_frags,
    true_objective_winning_the_game,
)
from sample_factory_tpu_torch.examples.vizdoom.doom_utils import DOOM_ENVS, doom_env_by_name  # noqa: E402
from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg  # noqa: E402
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic  # noqa: E402
from sample_factory_tpu_torch.runner.checkpoint import restore_from_jax_checkpoint  # noqa: E402

torch.set_num_threads(1)

STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "standins")  # vizdoom/, doom_battle_standin.py


@pytest.fixture(autouse=True)
def _fresh_contexts():
    reset_global_context()
    jax_reset_global_context()
    yield
    reset_global_context()
    jax_reset_global_context()


@pytest.fixture()
def standin_engine(monkeypatch):
    """`import vizdoom` finds the stand-in, here and in spawned workers."""
    monkeypatch.syspath_prepend(STANDIN_DIR)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([STANDIN_DIR, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.delitem(sys.modules, "vizdoom", raising=False)
    yield
    sys.modules.pop("vizdoom", None)


# ---------------------------------------------------------------- counterparts of tests/test_vizdoom_integration.py


def test_flatten_simple_discrete():
    space = GymDiscrete(4)
    assert flatten_doom_action(space, 0) == [0, 0, 0]  # 0 = no-op
    assert flatten_doom_action(space, 2) == [0, 1, 0]


def test_flatten_composite():
    space = doom_action_space_basic()  # Tuple(Discrete(3), Discrete(3))
    assert flatten_doom_action(space, (1, 2)) == [1, 0, 0, 1]
    assert flatten_doom_action(space, (0, 0)) == [0, 0, 0, 0]


def test_flatten_discretized_turning():
    space = doom_action_space_discretized_no_weap()
    flat = flatten_doom_action(space, (0, 0, 0, 0, 0))
    # 2+2+1+1 one-hot slots + 1 continuous value
    assert len(flat) == 7
    assert flat[-1] == pytest.approx(-10.0)  # bin 0 of Discretized(11, -10, 10)
    flat = flatten_doom_action(space, (0, 0, 0, 0, 10))
    assert flat[-1] == pytest.approx(+10.0)
    flat = flatten_doom_action(space, (0, 0, 0, 0, 5))
    assert flat[-1] == pytest.approx(0.0)
    # the port's specs flatten alike: the env-level stand-in's space, and the port's own Discretized
    from sample_factory_tpu_torch.envs.discretized import Discretized as SpecDiscretized
    from sample_factory_tpu_torch.envs.spaces import Discrete, TupleSpec

    spec = TupleSpec((Discrete(3), Discrete(3), Discrete(2), Discrete(2), SpecDiscretized(11, -10.0, 10.0)))
    assert flatten_doom_action(spec, (1, 2, 1, 0, 5)) == flatten_doom_action(space, (1, 2, 1, 0, 5)) == [1, 0, 0, 1, 1, 0, 0.0]


def test_flatten_box_delta_scaled():
    space = doom_action_space()  # last subspace is Box(-1, 1, (1,))
    flat = flatten_doom_action(space, (0, 0, 0, 0, 0, np.array([0.5], np.float32)))
    assert flat[-1] == pytest.approx(0.5 * 7.5)


def test_full_discretized_space_shape():
    space = doom_action_space_full_discretized(with_use=True)
    assert len(space.spaces) == 7
    assert isinstance(space.spaces[-1], Discretized) and isinstance(space.spaces[-1], GymDiscrete)
    assert space.spaces[-1].n == 21


def test_spec_registry():
    names = [s.name for s in DOOM_ENVS]
    assert len(names) == len(set(names))
    for expected in (
        "doom_basic",
        "doom_battle",
        "doom_battle2",
        "doom_benchmark",
        "doom_duel",
        "doom_deathmatch_full",
        "doom_health_gathering_supreme",
        "doom_dm",
    ):
        assert expected in names

    battle = doom_env_by_name("doom_battle")
    assert battle.default_timeout == 2100
    assert len(battle.extra_wrappers) == 2  # measurements + reward shaping

    duel = doom_env_by_name("doom_duel")
    assert duel.num_agents == 2 and duel.respawn_delay == 2

    with pytest.raises(RuntimeError):
        doom_env_by_name("doom_nonexistent")


class FakeDoomEnv(gym.Env):
    """Emits a scripted sequence of (reward, info) steps; mimics VizdoomEnv's
    game-variable infos."""

    def __init__(self, script, obs_shape=(32, 32, 3)):
        self.script = list(script)
        self.observation_space = GymBox(0, 255, obs_shape, dtype=np.uint8)
        self.action_space = GymDiscrete(4)
        self._t = 0
        self._obs = np.zeros(obs_shape, np.uint8)
        self.reward_shaping_interface = None

    def get_info(self):
        return dict(self.script[min(self._t, len(self.script) - 1)][1])

    def reset(self, *, seed=None, options=None):
        self._t = 0
        return self._obs, {}

    def step(self, action):
        reward, info = self.script[self._t]
        self._t += 1
        done = self._t >= len(self.script)
        return self._obs, reward, done, False, dict(info)


def test_reward_shaping_deltas():
    script = [
        (0.0, {"FRAGCOUNT": 0, "HEALTH": 100, "DEAD": 0.0}),
        (0.0, {"FRAGCOUNT": 1, "HEALTH": 100, "DEAD": 0.0}),  # +1 frag
        (0.0, {"FRAGCOUNT": 1, "HEALTH": 70, "DEAD": 0.0}),  # -30 health
        (1.0, {"FRAGCOUNT": 1, "HEALTH": 70, "DEAD": 0.0}),
    ]
    env = DoomRewardShapingWrapper(
        FakeDoomEnv(script), reward_shaping_scheme=REWARD_SHAPING_DEATHMATCH_V0, true_objective_func=None
    )
    env.reset()
    _, r0, *_ = env.step(0)  # first step: no prev vars -> no shaping
    assert r0 == 0.0
    _, r1, *_ = env.step(0)
    assert r1 == pytest.approx(1.0)  # FRAGCOUNT delta +1 * reward 1
    _, r2, *_ = env.step(0)
    assert r2 == pytest.approx(-30 * 0.003)  # health loss penalty (-delta * rewards[1])
    _, r3, term, trunc, info = env.step(0)
    assert term
    # true objective defaults to unshaped env reward
    assert info["true_objective"] == pytest.approx(1.0)


def test_reward_shaping_delta_cap():
    script = [
        (0.0, {"DAMAGECOUNT": 0, "DEAD": 0.0}),
        (0.0, {"DAMAGECOUNT": 1000, "DEAD": 0.0}),  # capped at 200
        (0.0, {"DAMAGECOUNT": 1000, "DEAD": 0.0}),
    ]
    env = DoomRewardShapingWrapper(FakeDoomEnv(script), reward_shaping_scheme=REWARD_SHAPING_BATTLE)
    env.reset()
    env.step(0)
    _, r, *_ = env.step(0)
    assert r == pytest.approx(200 * 0.003)


def test_reward_shaping_pbt_interface():
    env = DoomRewardShapingWrapper(FakeDoomEnv([(0.0, {})]), reward_shaping_scheme=REWARD_SHAPING_DEATHMATCH_V1)
    assert env.get_default_reward_shaping()["delta"]["FRAGCOUNT"] == (+1, -0.001)
    mutated = {"delta": {"FRAGCOUNT": (+2.0, 0.0)}, "selected_weapon": {}}
    env.set_reward_shaping(mutated, 0)
    assert env.get_default_reward_shaping() is mutated
    # the wrapper registers itself on the base env for PBT discovery
    assert env.env.unwrapped.reward_shaping_interface is env
    # the schemes are the JAX package's, value for value
    for name in ("REWARD_SHAPING_DEATHMATCH_V0", "REWARD_SHAPING_DEATHMATCH_V1", "REWARD_SHAPING_BATTLE"):
        assert getattr(jax_wrappers, name) == globals()[name]


def test_true_objectives():
    assert true_objective_frags({"FRAGCOUNT": 7}) == 7.0
    assert true_objective_winning_the_game({"LEADER_GAP": 0, "FINAL_PLACE": 1}) == 0.0  # tie
    assert true_objective_winning_the_game({"LEADER_GAP": -3, "FINAL_PLACE": 1}) == 1.0  # win
    assert true_objective_winning_the_game({"LEADER_GAP": 5, "FINAL_PLACE": 3}) == 0.0  # loss


def test_gathering_shaping():
    script = [
        (0.0, {"HEALTH": 50}),
        (0.0, {"HEALTH": 40}),  # losing health: no shaping
        (0.0, {"HEALTH": 60}),  # medkit! +1
        (0.5, {"HEALTH": 60}),
    ]
    env = DoomGatheringRewardShaping(FakeDoomEnv(script))
    env.reset()
    _, r0, *_ = env.step(0)
    _, r1, *_ = env.step(0)
    _, r2, *_ = env.step(0)
    assert (r0, r1, r2) == (0.0, 0.0, 1.0)
    _, _, term, _, info = env.step(0)
    assert term and info["true_objective"] == pytest.approx(0.5)


def test_multiplayer_stats():
    info = {
        "FRAGCOUNT": 10.0,
        "DEATHCOUNT": 4.0,
        "PLAYER_COUNT": 3,
        "PLAYER_NUMBER": 0,  # we are PLAYER1_*
        "PLAYER1_FRAGCOUNT": 10,
        "PLAYER2_FRAGCOUNT": 12,
        "PLAYER3_FRAGCOUNT": 3,
    }
    env = MultiplayerStatsWrapper(FakeDoomEnv([(0.0, info)] * 2))
    env.reset()
    _, _, _, _, out = env.step(0)
    assert out["KDR"] == pytest.approx(10.0 / 5.0)
    assert out["FINAL_PLACE"] == 2
    assert out["LEADER_GAP"] == 2  # 12 - 10

    # winner's gap is to the runner-up and non-positive
    winner = dict(info, PLAYER_NUMBER=1, FRAGCOUNT=12.0)
    env = MultiplayerStatsWrapper(FakeDoomEnv([(0.0, winner)] * 2))
    env.reset()
    _, _, _, _, out = env.step(0)
    assert out["FINAL_PLACE"] == 1 and out["LEADER_GAP"] == -2


def test_additional_input_measurements():
    info = {
        "SELECTED_WEAPON": 3.0,
        "SELECTED_WEAPON_AMMO": 150.0,  # scaled /15, capped at 5
        "HEALTH": -10.0,  # clamped to 0
        "ARMOR": 60.0,
        "WEAPON3": 1.0,
        "AMMO3": 30.0,
    }
    env = DoomAdditionalInput(FakeDoomEnv([(0.0, info)] * 3))
    assert isinstance(env.observation_space, gym.spaces.Dict)
    obs, _ = env.reset()
    obs, *_ = env.step(0)
    m = obs["measurements"]
    assert m[0] == 3.0
    assert m[1] == pytest.approx(5.0)  # ammo capped
    assert m[2] == 0.0  # health clamped
    assert m[3] == pytest.approx(2.0)  # armor / 30
    assert m[7 + 3] == 1.0  # WEAPON3
    assert m[7 + 8 + 3] == pytest.approx(2.0)  # AMMO3 / 15


class PixelEnv(gym.Env):
    def __init__(self, shape=(64, 48, 3)):
        self.observation_space = GymBox(0, 255, shape, dtype=np.uint8)
        self.action_space = GymDiscrete(2)
        self.unwrapped.skip_frames = 1

    def reset(self, *, seed=None, options=None):
        return np.full(self.observation_space.shape, 7, np.uint8), {}

    def step(self, action):
        return np.full(self.observation_space.shape, 7, np.uint8), 2.0, False, False, {}


def test_resize_wrapper():
    env = ResizeWrapper(PixelEnv(), w=32, h=24)
    assert env.observation_space.shape == (24, 32, 3)
    obs, _ = env.reset()
    assert obs.shape == (24, 32, 3) and obs.dtype == np.uint8
    assert np.all(obs == 7)


def test_reward_scaling_wrapper():
    env = RewardScalingWrapper(PixelEnv(), 0.25)
    env.reset()
    _, r, *_ = env.step(0)
    assert r == pytest.approx(0.5)


def test_time_limit_wrapper():
    env = TimeLimitWrapper(PixelEnv(), limit=3)
    env.reset()
    for _ in range(2):
        _, _, term, trunc, info = env.step(0)
        assert not term and not trunc
    _, _, term, trunc, info = env.step(0)
    assert trunc and not term and info.get("time_outs")
    env.reset()
    _, _, _, trunc, _ = env.step(0)
    assert not trunc  # counter reset


def test_vizdoom_encoder_forward():
    from sample_factory_tpu_torch.cfg.arguments import default_cfg

    cfg = default_cfg(env="doom_battle", argv=["--encoder_conv_architecture=convnet_simple", "--device=cpu"])
    obs_space = gym.spaces.Dict(
        {
            "obs": GymBox(0, 255, (72, 128, 3), dtype=np.uint8),
            "measurements": GymBox(-50.0, 50.0, (23,), dtype=np.float32),
        }
    )
    encoder = doom_utils.make_vizdoom_encoder(cfg, from_gym_space(obs_space))
    obs = {"obs": torch.zeros((4, 72, 128, 3)), "measurements": torch.zeros((4, 23))}
    out = encoder(obs)
    assert out.shape[0] == 4 and out.ndim == 2
    assert out.shape[1] == encoder.get_out_size() == 512 + 128


def test_parse_vizdoom_cfg():
    cfg = parse_vizdoom_cfg(argv=["--env=doom_battle", "--experiment=test_doom"])
    # paper-tuned doom defaults applied
    assert cfg.exploration_loss == "symmetric_kl"
    assert cfg.env_frameskip == 4
    assert cfg.res_w == 128 and cfg.res_h == 72
    assert cfg.num_bots == -1
    # value for value the JAX package's flags; no rnn_type is set, so Doom's policy is the cfg's GRU-512
    jcfg = jax_parse_vizdoom_cfg(argv=["--env=doom_battle", "--experiment=test_doom"])
    for key in ("ppo_clip_value", "obs_subtract_mean", "obs_scale", "exploration_loss", "exploration_loss_coeff", "normalize_returns",
                "normalize_input", "env_frameskip", "eval_env_frameskip", "fps", "num_agents", "num_humans", "num_bots", "timelimit",
                "res_w", "res_h", "wide_aspect_ratio", "rnn_type", "rnn_size", "compute_dtype", "encoder_conv_architecture"):
        assert cfg[key] == jcfg[key], key
    assert (cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype) == ("gru", 512, "float32")


def test_tile_grid_layout():
    from sample_factory_tpu_torch.examples.vizdoom.doom.doom_render import as_hwc, tile_grid

    frames = [np.full((8, 10, 3), i, np.uint8) for i in range(5)]
    grid = tile_grid(frames, max_cols=3)
    # 5 frames -> 2 rows x 3 cols with one black pad
    assert grid.shape == (16, 30, 3)
    assert grid[0, 0, 0] == 0 and grid[0, 10, 0] == 1 and grid[0, 20, 0] == 2
    assert grid[8, 0, 0] == 3 and grid[8, 10, 0] == 4
    assert np.all(grid[8:, 20:] == 0)  # pad slot is black

    chw = np.arange(2 * 4 * 6, dtype=np.uint8).reshape(2, 4, 6)
    assert as_hwc(chw).shape == (4, 6, 2)
    hwc = np.zeros((4, 6, 3), np.uint8)
    assert as_hwc(hwc).shape == (4, 6, 3)


def test_step_human_input_advances_engine():
    """StepHumanInput ignores policy actions and drives the env through the
    engine's human/spectator interface (advance_human_or_replay)."""
    from sample_factory_tpu_torch.examples.vizdoom.doom.human_play import StepHumanInput

    class FakeHumanDoom(gym.Env):
        observation_space = GymBox(0, 255, (8, 8, 3), dtype=np.uint8)
        action_space = GymDiscrete(4)

        def __init__(self):
            self.mode = "player"
            self.initialized = False
            self.advanced = 0
            self.closed = 0

        def _ensure_initialized(self):
            self.initialized = True

        def close(self):
            self.closed += 1

        def reset(self, *, seed=None, options=None):
            return np.zeros((8, 8, 3), np.uint8), {}

        def advance_human_or_replay(self):
            self.advanced += 1
            return np.zeros((8, 8, 3), np.uint8), 1.5, self.advanced >= 3

        def step(self, action):  # pragma: no cover - must NOT be called
            raise AssertionError("policy step() must not drive human mode")

    env = FakeHumanDoom()
    wrapped = StepHumanInput(env)
    wrapped.reset()
    assert env.mode == "human" and env.initialized
    done, total = False, 0.0
    while not done:
        _o, r, done, _t, _i = wrapped.step(0)
        total += r
    assert env.advanced == 3 and total == pytest.approx(4.5)


# ---------------------------------------------------------------- the port against the JAX package


def test_registry_matches_jax():
    """Every spec value for value: scenario file, action space (as static specs), reward scaling,
    timeout, agents, bots, respawn delay, time limit and the extra wrappers with their arguments."""
    jspecs, tspecs = jax_doom_utils.DOOM_ENVS, doom_utils.DOOM_ENVS
    assert [s.name for s in tspecs] == [s.name for s in jspecs] and len(tspecs) == 20
    for j, t in zip(jspecs, tspecs):
        assert (t.env_spec_file, t.reward_scaling, t.default_timeout, t.num_agents, t.num_bots, t.respawn_delay, t.timelimit) == (
            j.env_spec_file, j.reward_scaling, j.default_timeout, j.num_agents, j.num_bots, j.respawn_delay, j.timelimit), t.name
        assert repr(from_gym_space(t.action_space)) == repr(jax_from_gym_space(j.action_space)).replace("sample_factory_tpu.", ""), t.name
        named = lambda wrappers: [(w.__name__, {k: getattr(v, "__name__", v) for k, v in kw.items()}) for w, kw in wrappers]  # noqa: E731
        assert named(t.extra_wrappers) == named(j.extra_wrappers), t.name


def _action_sampler(space, seed):
    rng = np.random.default_rng(seed)
    if hasattr(space, "spaces"):
        return lambda: tuple(int(rng.integers(s.n)) for s in space.spaces)
    return lambda: int(rng.integers(space.n))


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=what)
        assert np.asarray(b).dtype == np.asarray(a).dtype, what
    else:
        assert b == a, what


@pytest.mark.parametrize("env_name", ["doom_basic", "doom_battle", "doom_duel_bots"])
def test_env_matches_jax_over_the_standin_engine(standin_engine, env_name):
    """make_doom_env of both packages, each with its own engine: the whole wrapper stack (match
    stats, resolution 160x120 -> 128x72, time limit, measurements, reward shaping, reward scaling;
    for doom_duel_bots the hosting player with a bot), reset with one seed, then 200 steps of one
    random action sequence: observations (frames and measurements), rewards, terminations,
    truncations and infos are equal, across episode ends (reset after each)."""
    argv = [f"--env={env_name}", "--experiment=e"]
    jenv = jax_doom_utils.make_doom_env(env_name, jax_parse_vizdoom_cfg(argv))
    tenv = doom_utils.make_doom_env(env_name, parse_vizdoom_cfg(argv + ["--device=cpu"]))
    try:
        assert from_gym_space(tenv.observation_space) == from_gym_space(jenv.observation_space)
        (jobs, jinfo), (tobs, tinfo) = jenv.reset(seed=11), tenv.reset(seed=11)
        _assert_same(jobs, tobs, "reset")
        _assert_same(jinfo, tinfo, "reset info")
        sample, ends, shaped = _action_sampler(tenv.action_space, 0), 0, 0
        for step in range(200):
            action = sample()
            jout, tout = jenv.step(action), tenv.step(action)
            for k, what in enumerate(("obs", "reward", "terminated", "truncated", "info")):
                _assert_same(jout[k], tout[k], f"step {step} {what}")
            shaped += tout[1] not in (0.0, -0.01)
            if tout[2] or tout[3]:
                ends += 1
                (jobs, _), (tobs, _) = jenv.reset(), tenv.reset()
                _assert_same(jobs, tobs, f"reset after step {step}")
        assert ends >= 1 and shaped > 0
        obs = tobs["obs"] if isinstance(tobs, dict) else tobs
        assert obs.shape == (72, 128, 3) and obs.dtype == np.uint8
        if env_name != "doom_basic":
            assert tobs["measurements"].shape == (23,) and tobs["measurements"].dtype == np.float32
    finally:
        jenv.close()
        tenv.close()


def test_two_player_match_matches_jax(standin_engine):
    """doom_duel: two networked players as one multi-agent env (a thread per player, the frameskip
    tic by tic in lockstep). The JAX class raises on its first step (gymnasium's wrappers do not
    forward `step_tick`; a fault of the JAX side, not copied), so the port's match is held against
    the JAX package's own player stacks driven in lockstep by hand: the first 3 tics on each
    base env, the last through each stack. Per-agent outputs equal for 50 steps."""
    argv = ["--env=doom_duel", "--experiment=e"]
    jcfg = jax_parse_vizdoom_cfg(argv)
    jenv = jax_doom_utils.make_doom_env("doom_duel", jcfg)
    tenv = doom_utils.make_doom_env("doom_duel", parse_vizdoom_cfg(argv + ["--device=cpu"]))
    port = tenv._players[0].env.unwrapped.port
    spec = jax_doom_utils.doom_env_by_name("doom_duel")
    players = [jax_doom_utils.make_doom_env_impl(spec, jcfg, player_id=i, num_agents=2, max_num_players=2, num_bots=0, port=port)
               for i in range(2)]
    try:
        assert tenv.num_agents == jenv.num_agents == 2 and tenv.is_multiagent and tenv.skip_frames == 4
        assert from_gym_space(tenv.action_space) == from_gym_space(jenv.action_space)
        samplers = [_action_sampler(tenv.action_space, seed) for seed in (1, 2)]
        jenv.reset()
        with pytest.raises(AttributeError, match="step_tick"):
            jenv.step([s() for s in samplers])

        tobs, _ = tenv.reset()
        jobs = [p.reset()[0] for p in players]
        for agent in range(2):
            _assert_same(jobs[agent], tobs[agent], f"reset agent {agent}")
        ends = 0
        for step in range(50):
            actions = [s() for s in samplers]
            tout = tenv.step(actions)
            for _ in range(3):
                for p, a in zip(players, actions):
                    p.unwrapped.step_tick(a, False)
            jout = list(map(list, zip(*[p.step(a) for p, a in zip(players, actions)])))
            if all(jout[2]):
                ends += 1
                jout[0] = [p.reset()[0] for p in players]
                for info in jout[4]:
                    info["episode_done"] = True
            for k, what in enumerate(("obs", "rewards", "terminated", "truncated", "infos")):
                for agent in range(2):
                    _assert_same(jout[k][agent], tout[k][agent], f"step {step} {what} agent {agent}")
        assert tout[4][0]["PLAYER_COUNT"] == 2 and tout[4][1]["PLAYER_NUMBER"] == 1 and "FINAL_PLACE" in tout[4][0]
        assert tobs[0]["obs"].shape == (72, 128, 3) and tout[0][1]["measurements"].shape == (23,)
        assert tenv.get_default_reward_shaping() == REWARD_SHAPING_DEATHMATCH_V1
    finally:
        jenv.close()
        tenv.close()
        for p in players:
            p.close()


def test_host_stack_repeats_actions_once(standin_engine):
    """The engine repeats each action env_frameskip (4) tics. Over the host stack
    (`wrap_host_env`) the port steps 4 tics a policy step; the JAX package's worker adds a
    FrameskipWrapper on top (gymnasium's wrappers hide VizdoomEnv's frameskip flag), 16 tics."""
    argv = ["--env=doom_basic", "--experiment=e"]
    jcfg, tcfg = jax_parse_vizdoom_cfg(argv), parse_vizdoom_cfg(argv + ["--device=cpu"])
    jenv = jax_wrap_host_env(jax_doom_utils.make_doom_env("doom_basic", jcfg), jcfg)
    tenv = wrap_host_env(doom_utils.make_doom_env("doom_basic", tcfg), tcfg)
    tics = {}
    for name, env in (("jax", jenv), ("port", tenv)):
        env.reset(seed=3)
        game = env.unwrapped.game
        before = game._tic
        env.step(0)
        tics[name] = game._tic - before
        env.close()
    assert tics == {"port": 4, "jax": 16}


def test_play_tools_run_over_the_standin_engine(standin_engine, tmp_path, monkeypatch):
    """`play_doom` (keyboard spectator mode: one engine tic a step) and `doom_play_demo` (a demo
    replayed into an mp4 at 1280x720) build their env from the Doom flags; the JAX tools build it
    from `default_cfg`, which lacks `--res_w` (a fault of the JAX side, not copied)."""
    from sample_factory_tpu.cfg.arguments import default_cfg as jax_default_cfg

    from sample_factory_tpu_torch.examples.vizdoom import doom_play_demo, play_doom

    with pytest.raises(AttributeError, match="res_w"):
        jax_doom_utils.make_doom_env_impl(jax_doom_utils.doom_env_by_name("doom_basic"), cfg=jax_default_cfg(env="doom_basic"),
                                          custom_resolution="1280x720")
    monkeypatch.setattr(sys, "argv", ["play_doom", "--env=doom_basic", "--episodes=1"])
    assert play_doom.main() == 0
    video = doom_play_demo.replay_demo("doom_basic", str(tmp_path / "e000.lmp"), write_frames=False)
    assert os.path.getsize(video) > 0


def test_card_standin_declares_the_real_stack_spaces(standin_engine):
    """`tests/standins/doom_battle_standin.py` (what the card drives, without gymnasium) has the
    spaces and the reward shaping of doom_battle's real stack, as the port's specs give them."""
    sys.path.insert(0, STANDIN_DIR)
    try:
        import doom_battle_standin as standin
    finally:
        sys.path.remove(STANDIN_DIR)
    real = doom_utils.make_doom_env("doom_battle", parse_vizdoom_cfg(["--env=doom_battle", "--experiment=e", "--device=cpu"]))
    env = standin.make_doom_battle_standin("doom_battle", None, {"env_id": 3})
    try:
        assert env.observation_space == from_gym_space(real.observation_space)
        assert env.action_space == from_gym_space(real.action_space)
        assert env.get_default_reward_shaping() == real.get_default_reward_shaping()
        obs, _ = env.reset(seed=1)
        m = obs["measurements"]
        low, high = real.observation_space["measurements"].low, real.observation_space["measurements"].high
        assert obs["obs"].shape == (72, 128, 3) and m.dtype == np.float32 and np.all((m >= low) & (m <= high))
        standin.register_doom_battle_standin()
        assert global_model_factory().encoder_factory is doom_utils.make_vizdoom_encoder
    finally:
        real.close()


# ---------------------------------------------------------------- the model through the bridge

OBS = (72, 128, 3)
N_MEAS = 23
NARROW = ["--use_rnn=True", "--rnn_size=32", "--encoder_conv_mlp_layers", "32", "--seed=0"]


def _spaces(box, dict_spec, discrete, tuple_spec):
    obs = dict_spec({"obs": box(OBS, 0.0, 255.0, "uint8"), "measurements": box((N_MEAS,), -50.0, 50.0, "float32")})
    return obs, tuple_spec((discrete(3), discrete(3), discrete(2), discrete(2), discrete(11)))


def _models(dtype="float32", extra=()):
    from sample_factory_tpu.envs import spaces as js

    from sample_factory_tpu_torch.envs import spaces as ts

    argv = ["--env=doom_battle", "--experiment=e", f"--compute_dtype={dtype}"] + NARROW + list(extra)
    jcfg, tcfg = jax_parse_vizdoom_cfg(argv), parse_vizdoom_cfg(argv + ["--device=cpu"])
    jax_doom_utils.register_vizdoom_components()
    doom_utils.register_vizdoom_components()
    jspaces, tspaces = _spaces(js.Box, js.make_dict_spec, js.Discrete, js.TupleSpec), _spaces(ts.Box, ts.make_dict_spec, ts.Discrete, ts.TupleSpec)
    jmodel = jax_create_actor_critic(jcfg, *jspaces)
    tmodel = create_actor_critic(tcfg, *tspaces)
    return jcfg, tcfg, jmodel, tmodel, jspaces, tspaces


def _obs(rng, lead):
    return {"obs": rng.integers(0, 256, lead + OBS).astype(np.float32) / 255.0,
            "measurements": rng.normal(size=lead + (N_MEAS,)).astype(np.float32)}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.03)])
def test_vizdoom_encoder_matches_jax_through_the_bridge(dtype, tol):
    """The registered VizdoomEncoder inside the actor-critic (convnet_simple over 72x128x3, the
    measurements MLP, GRU, the tuple head), one flax parameter set carried in strictly: the head,
    the logits and values of a step and of a BPTT sequence with resets equal JAX's."""
    _, _, jmodel, tmodel, _, _ = _models(dtype)
    assert isinstance(tmodel.encoder, VizdoomEncoder) and tmodel.encoder.get_out_size() == 32 + 128
    rng = np.random.default_rng(0)
    obs = _obs(rng, (6,))
    rnn = rng.normal(size=(6, 32)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, obs), jnp.asarray(rnn))
    assert params["params"]["encoder"]["measurements_fc1"]["kernel"].shape == (128, 128)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    jhead = jmodel.apply(params, jax.tree.map(jnp.asarray, obs), method="forward_head")
    jlogits, jvalues, jstate = jmodel.apply(params, jax.tree.map(jnp.asarray, obs), jnp.asarray(rnn))
    seq = _obs(rng, (5, 3))  # [T, B, ...]
    resets = (rng.random((5, 3)) < 0.3).astype(np.float32)
    jseq_head = jmodel.apply(params, jax.tree.map(jnp.asarray, seq), method="forward_head")
    jcore, jfinal = jmodel.apply(params, jseq_head, jnp.asarray(rnn[:3]), jnp.asarray(resets), method="forward_core_seq")
    with torch.no_grad():
        tobs = {k: torch.tensor(v) for k, v in obs.items()}
        thead = tmodel.forward_head(tobs)
        tlogits, tvalues, tstate = tmodel(tobs, torch.tensor(rnn))
        tseq_head = tmodel.forward_head({k: torch.tensor(v) for k, v in seq.items()})
        tcore, tfinal = tmodel.forward_core_seq(tseq_head, torch.tensor(rnn[:3]), torch.tensor(resets))
    for got, want in ((thead, jhead), (tlogits, jlogits), (tvalues, jvalues), (tstate, jstate), (tseq_head, jseq_head),
                      (tcore, jcore), (tfinal, jfinal)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)


def test_bridge_round_trip_of_the_doom_model():
    """flax -> torch -> flax: every leaf of the tree comes back unchanged (the measurements Denses
    transposed twice, the Dense after the convs permuted twice)."""
    _, _, jmodel, tmodel, _, _ = _models()
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, _obs(rng, (2,))), jnp.zeros((2, 32))))
    bridge.load_flax_params(tmodel, params)
    back = dict(jax.tree_util.tree_leaves_with_path(bridge.state_dict_to_flax(tmodel.state_dict(), tmodel)))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back) == len(tmodel.state_dict())
    for path, value in flat:
        np.testing.assert_array_equal(back[path], value)


T, N = 8, 4


def test_one_update_under_doom_params_matches_jax():
    """One train call of each package from one parameter set on one trajectory with episode ends
    inside it: doom_params (symmetric-KL exploration, normalized inputs and returns, value clip
    0.2), GRU over BPTT segments of 8, the tuple action head; 2 minibatches, 1 epoch. Parameters,
    normalizers and the learning rate after it: 1e-5."""
    argv = [f"--rollout={T}", f"--recurrence={T}", f"--batch_size={T * N // 2}", f"--num_envs={N}", "--num_epochs=1"]
    jcfg, tcfg, jmodel, tmodel, jspaces, tspaces = _models(extra=argv)
    assert tcfg.exploration_loss == "symmetric_kl" and tcfg.normalize_input and tcfg.normalize_returns and tcfg.ppo_clip_value == 0.2
    jinfo = JaxEnvInfo(obs_space=jspaces[0], action_space=jspaces[1], num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=tspaces[0], action_space=tspaces[1], num_agents=1, is_device_env=False)
    tx = jax_make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    sample = {"obs": jnp.zeros((2,) + OBS, jnp.uint8), "measurements": jnp.zeros((2, N_MEAS), jnp.float32)}
    jts = jax_init_train_state(jcfg, jinfo, jmodel, tx, jax.random.PRNGKey(0), sample)
    bridge.load_flax_params(tmodel, jax.tree.map(np.asarray, jts.params))
    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")

    logits_w = 3 + 3 + 2 + 2 + 11
    traj = {
        "obs": {"obs": rng.integers(0, 256, (T + 1, N) + OBS).astype(np.uint8),
                "measurements": rng.normal(size=(T + 1, N, N_MEAS)).astype(np.float32) * 5},
        "rnn_states": rng.normal(size=(T + 1, N, 32)).astype(np.float32) * 0.5,
        "actions": np.stack([rng.integers(0, n, size=(T, N)) for n in (3, 3, 2, 2, 11)], -1).astype(np.int32),
        "action_logits": rng.normal(size=(T, N, logits_w)).astype(np.float32) * 0.1,
        "log_prob_actions": np.log(rng.uniform(0.002, 0.01, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "time_outs": np.zeros((T, N), np.float32),
        "policy_version": np.zeros((T, N), np.int32),
        "policy_id": np.zeros((T, N), np.int32),
    }
    to = lambda tree, fn: {k: to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}  # noqa: E731
    jts2, jstats = jax.jit(jax_make_train_fn(jcfg, jinfo, jmodel, tx))(jts, to(traj, jnp.asarray), jax.random.PRNGKey(1))
    tstats = make_train_fn(tcfg, tinfo)(tts, to(traj, torch.tensor), torch.Generator().manual_seed(1))
    assert tts.train_step == int(jts2.train_step) == 2
    assert tts.curr_lr == pytest.approx(float(jts2.curr_lr))
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jts2.params), tts.model)
    for name, value in tts.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
    for key in ("obs", "measurements"):
        np.testing.assert_allclose(tts.obs_rms[key].running_mean.numpy(), np.asarray(jts2.obs_rms[key].running_mean), atol=1e-5)
        np.testing.assert_allclose(tts.obs_rms[key].running_var.numpy(), np.asarray(jts2.obs_rms[key].running_var), atol=1e-5)
    np.testing.assert_allclose(tts.returns_rms.running_var.numpy(), np.asarray(jts2.returns_rms.running_var), atol=1e-5)
    assert np.isfinite(float(tstats["loss"])) and np.isfinite(float(jstats["loss"]))  # each reports a minibatch of its own draw


def test_jax_checkpoint_of_the_doom_model_restores_in_the_port(tmp_path):
    """A JAX `.msgpack` of the example's train state (normalizers moved off their initial values)
    restores in the port through `restore_from_jax_checkpoint`: the same logits, values and rnn
    state on the same uint8 frames and measurements, 1e-5."""
    from sample_factory_tpu.algo.running_mean_std import obs_rms_normalize as jax_obs_rms_normalize
    from sample_factory_tpu.algo.running_mean_std import obs_rms_update as jax_obs_rms_update
    from sample_factory_tpu.algo.sampling import _static_preprocess as jax_static_preprocess

    argv = [f"--train_dir={tmp_path}"]
    jcfg, tcfg, jmodel, tmodel, jspaces, tspaces = _models(extra=argv)
    jinfo = JaxEnvInfo(obs_space=jspaces[0], action_space=jspaces[1], num_agents=1, is_device_env=False)
    tinfo = EnvInfo(obs_space=tspaces[0], action_space=tspaces[1], num_agents=1, is_device_env=False)
    rng = np.random.default_rng(2)
    frames = {"obs": rng.integers(0, 256, (6,) + OBS).astype(np.uint8), "measurements": rng.normal(size=(6, N_MEAS)).astype(np.float32)}
    jts = jax_init_train_state(jcfg, jinfo, jmodel, jax_make_optimizer(jcfg), jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, frames))
    pre = jax_static_preprocess(jcfg, jax.tree.map(jnp.asarray, frames))
    jts = jts.replace(obs_rms=jax_obs_rms_update(jts.obs_rms, pre))
    path = jax_save_checkpoint(jcfg, 0, jts, 4096, 1.5)
    rnn = rng.normal(size=(6, 32)).astype(np.float32)
    jlogits, jvalues, jstate = jmodel.apply(jts.params, jax_obs_rms_normalize(jts.obs_rms, pre), jnp.asarray(rnn))

    tts = init_train_state(tcfg, tinfo, tmodel, "cpu")
    assert restore_from_jax_checkpoint(tts, path)[0] == 4096
    with torch.no_grad():
        tlogits, tvalues, tstate = tts.model(normalize_obs(tcfg, tts.obs_rms, {k: torch.tensor(v) for k, v in frames.items()}),
                                             torch.tensor(rnn))
    for got, want in ((tlogits, jlogits), (tvalues, jvalues), (tstate, jstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- the example end to end


def test_train_vizdoom_through_worker_processes_then_enjoy(standin_engine, tmp_path):
    """`train_vizdoom.main` on doom_battle at doom_params (async, the quantized learner, GRU) cut
    to 2 workers x 4 envs and a short rollout, the gymnasium stack in worker processes over the
    stand-in engine: it trains and writes a checkpoint; `enjoy_vizdoom.main` plays it back."""
    from sample_factory_tpu_torch.examples.vizdoom import enjoy_vizdoom, train_vizdoom

    argv = ["--env=doom_battle", "--experiment=battle", f"--train_dir={tmp_path}", "--device=cpu", "--num_workers=2",
            "--num_envs_per_worker=4", "--worker_num_splits=2", "--rollout=16", "--recurrence=16", "--batch_size=64",
            "--train_for_env_steps=4096", "--use_rnn=True", "--rnn_size=32", "--encoder_conv_mlp_layers", "32", "--seed=0",
            "--decorrelate_envs_on_one_worker=False"]
    assert train_vizdoom.main(argv) == 0
    assert glob.glob(os.path.join(str(tmp_path), "battle", "checkpoint_p0", "checkpoint_*.pth"))
    assert enjoy_vizdoom.main(argv + ["--no_render", "--max_num_episodes=2"]) == 0
