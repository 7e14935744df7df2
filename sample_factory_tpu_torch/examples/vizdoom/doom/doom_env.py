"""Single-player VizDoom gymnasium env.

Copy of `sf_examples_tpu/vizdoom/doom/doom_env.py` (reference `sf_examples/vizdoom/doom/doom_gym.py`
(VizdoomEnv): composite-action flattening, frameskip through the engine's
`make_action`, game variables surfaced in infos, black frame + last-frame
info on episode end, 32-bit seeding, optional .lmp demo recording, and
file-lock-throttled engine init (many engines booting at once is unstable).

Differences from the reference: scenario files are resolved from the
installed vizdoom package / $SF_DOOM_SCENARIOS_DIR instead of a bundled
scenarios dir (the battle/duel wads are distributed with the original
sample-factory repo and drop into that dir); locking uses fcntl directly
(no filelock dependency); no pygame human-render path (rgb_array only —
`enjoy` handles display).
"""

from __future__ import annotations

import fcntl
import os
import random
import re
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None

from sample_factory_tpu_torch.utils.utils import log
from sample_factory_tpu_torch.examples.vizdoom.doom.action_space import flatten_doom_action


def doom_available() -> bool:
    try:
        import vizdoom  # noqa: F401

        return True
    except ImportError:
        return False


def resolve_scenario_path(config_file: str) -> str:
    """Locate a scenario .cfg: absolute path, $SF_DOOM_SCENARIOS_DIR, then the
    scenarios shipped with the vizdoom package."""
    if os.path.isabs(config_file):
        return config_file
    user_dir = os.environ.get("SF_DOOM_SCENARIOS_DIR")
    if user_dir and os.path.isfile(os.path.join(user_dir, config_file)):
        return os.path.join(user_dir, config_file)
    import vizdoom

    candidate = os.path.join(vizdoom.scenarios_path, config_file)
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError(
        f"Doom scenario {config_file} not found (looked in $SF_DOOM_SCENARIOS_DIR and "
        f"{vizdoom.scenarios_path}). The battle/duel/deathmatch scenario files ship with the "
        "original sample-factory repo; point SF_DOOM_SCENARIOS_DIR at them."
    )


class _InitLock:
    """Throttle concurrent engine inits: at most `max_parallel` processes boot
    a DoomGame at once (reference doom_gym.py:21-37 used filelock for this).
    Lock files live in the system tmp dir so the throttle spans experiments."""

    def __init__(self, max_parallel: int = 10):
        slot = random.randrange(0, max_parallel)
        self._path = os.path.join(tempfile.gettempdir(), f"sf_tpu_doom_{slot:03d}.lock")
        self._fd = None

    def __enter__(self):
        self._fd = open(self._path, "w")
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        self._fd.close()


def parse_game_variable_names(config_path: str) -> Dict[str, int]:
    """Map game-variable name -> index from the scenario cfg's
    available_game_variables block (reference doom_gym.py:276-297)."""
    with open(config_path) as f:
        text = f.read()
    match = re.search(r"available_game_variables\s*=\s*\{([^}]*)\}", text)
    if not match:
        return {}
    names = match.group(1).split()
    return {name: i for i, name in enumerate(names)}


class VizdoomEnv(gym.Env if gym else object):
    metadata = {"render_modes": ["rgb_array"]}
    # the engine repeats the action (`make_action(flat, skip_frames)`): the host worker adds no
    # FrameskipWrapper on top (`envs/gym_wrappers.wrap_host_env`); the JAX class lacks the flag
    # and its worker repeats each action env_frameskip times more
    _sf_handles_frameskip = True

    # variables the engine fails to zero on new_episode(); corrected by
    # subtracting the previous episode's final value (doom_gym.py:411-421)
    STICKY_VARIABLES = ("DEATHCOUNT", "HITCOUNT", "DAMAGECOUNT")

    def __init__(
        self,
        action_space,
        config_file: str,
        skip_frames: int = 1,
        async_mode: bool = False,
        record_to: Optional[str] = None,
        render_mode: Optional[str] = None,
    ):
        if not doom_available():
            raise RuntimeError("The ViZDoom integration requires `pip install vizdoom`.")

        self.game = None
        self.initialized = False
        self.skip_frames = skip_frames
        self.async_mode = async_mode
        # engine interaction mode: "player" (policy acts), "human" (keyboard
        # spectator input, reference wrappers/step_human_input.py), "replay"
        # (.lmp demo playback, reference doom_play_demo.py)
        self.mode = "player"
        self.record_to = record_to
        self.render_mode = render_mode
        self.is_multiplayer = False
        self.reward_shaping_interface = None  # set by DoomRewardShapingWrapper

        self.action_space = action_space
        # engine render size; SetResolutionWrapper may override before init
        self.screen_w, self.screen_h, self.channels = 640, 480, 3
        import vizdoom

        self.screen_resolution = vizdoom.ScreenResolution.RES_640X480
        self.calc_observation_space()

        self.config_path = resolve_scenario_path(config_file)
        self.variable_indices = parse_game_variable_names(self.config_path)

        self.curr_seed = 0
        self.rng = None
        self._black = None
        self._prev_info: Optional[dict] = None
        self._last_episode_info: Optional[dict] = None
        self._num_episodes = 0
        self.seed()

    # -- setup ------------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        from gymnasium.utils import seeding

        self.rng, self.curr_seed = seeding.np_random(seed=seed)
        self.curr_seed = int(self.curr_seed) % (2**32)  # engine seeds are 32-bit
        return [self.curr_seed, self.rng]

    def calc_observation_space(self):
        self.observation_space = gym.spaces.Box(
            0, 255, (self.screen_h, self.screen_w, self.channels), dtype=np.uint8
        )

    def _create_game(self):
        import vizdoom

        game = vizdoom.DoomGame()
        game.load_config(self.config_path)
        game.set_screen_resolution(self.screen_resolution)
        game.set_seed(self.curr_seed)
        if self.mode == "human":
            game.set_window_visible(True)
            game.set_mode(vizdoom.Mode.ASYNC_SPECTATOR)
        elif self.mode == "replay":
            game.set_window_visible(False)
            game.set_mode(vizdoom.Mode.PLAYER)
        else:
            game.set_window_visible(False)
            game.set_mode(vizdoom.Mode.ASYNC_PLAYER if self.async_mode else vizdoom.Mode.PLAYER)
        return game

    def advance_human_or_replay(self):
        """One engine tic driven by recorded/keyboard input instead of the
        policy (human + replay modes). Returns (obs, reward, terminated)."""
        self._ensure_initialized()
        self.game.advance_action()
        state = self.game.get_state()
        reward = self.game.get_last_reward()
        terminated = self.game.is_episode_finished()
        obs = self._screen(state) if not terminated else self._black_screen()
        return obs, reward, terminated

    def _game_init(self):
        with _InitLock():
            self.game.init()

    def initialize(self):
        self.game = self._create_game()
        self._game_init()
        self.initialized = True

    def _ensure_initialized(self):
        if not self.initialized:
            self.initialize()

    # -- helpers ----------------------------------------------------------

    def _black_screen(self):
        if self._black is None:
            self._black = np.zeros(self.observation_space.shape, np.uint8)
        return self._black

    def _screen(self, state) -> np.ndarray:
        img = getattr(state, "screen_buffer", None) if state is not None else None
        if img is None:
            return self._black_screen()
        return np.transpose(img, (1, 2, 0))  # engine gives CHW

    def _variables(self, state) -> dict:
        if state is None:
            return {}
        values = state.game_variables
        return {name: values[i] for name, i in self.variable_indices.items()}

    def get_info(self, variables: Optional[dict] = None) -> dict:
        if variables is None:
            variables = self._variables(self.game.get_state())
        return dict(variables)

    def _fix_sticky_variables(self, info: dict):
        if self._last_episode_info is None:
            return
        for v in self.STICKY_VARIABLES:
            if v in info:
                info[v] -= self._last_episode_info.get(v, 0)

    # -- gym API ----------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self.seed(seed)
        self._ensure_initialized()

        started = False
        if self.record_to and not self.is_multiplayer:
            os.makedirs(self.record_to, exist_ok=True)
            demo_path = os.path.join(self.record_to, f"e{self._num_episodes:03d}.lmp")
            if len(demo_path) > 101:
                # engine limitation on demo path length
                log.error("Demo path %s too long (>101 chars), not recording", demo_path)
            else:
                self.game.new_episode(demo_path)
                started = True
        if self._num_episodes > 0 and not started:
            self.game.new_episode()

        obs = self._screen(self.game.get_state())
        self._last_episode_info = dict(self._prev_info) if self._prev_info else None
        self._prev_info = None
        self._num_episodes += 1
        return obs, {}

    def step(self, actions):
        flat = flatten_doom_action(self.action_space, actions)
        reward = self.game.make_action(flat, self.skip_frames)
        state = self.game.get_state()
        done = self.game.is_episode_finished()

        info = {"num_frames": self.skip_frames}
        if not done:
            obs = self._screen(state)
            info.update(self.get_info(self._variables(state)))
            self._prev_info = dict(info)
        else:
            # the engine forbids reading variables after done; reuse last frame's
            obs = self._black_screen()
            if self._prev_info:
                info.update(self._prev_info)
        self._fix_sticky_variables(info)
        return obs, reward, done, False, info

    def render(self) -> Optional[np.ndarray]:
        if self.render_mode != "rgb_array":
            return None
        try:
            return self._screen(self.game.get_state())
        except AttributeError:
            return None

    def close(self):
        try:
            if self.game is not None:
                self.game.close()
        except RuntimeError as exc:
            log.warning("VizDoom close() error: %r", exc)
