"""Atari (ALE) integration: env registry + the standard DeepMind wrapper stack.

Copy of `sf_examples_tpu/atari/atari_utils.py` (reference `sf_examples/atari/atari_utils.py`:
the same env names, gym ids and wrapper order, chosen there to match SB3 and CleanRL). The
wrappers subclass gymnasium's, as on the JAX side: they run where gymnasium is installed,
and `make_atari_env` raises without `ale_py`. The module itself imports without either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None


def atari_available() -> bool:
    try:
        import ale_py  # noqa: F401

        return True
    except ImportError:
        return False


class AtariSpec:
    def __init__(self, name: str, env_id: str, default_timeout: Optional[int] = None):
        self.name = name
        self.env_id = env_id
        self.default_timeout = default_timeout


ATARI_ENVS = [
    AtariSpec("atari_alien", "AlienNoFrameskip-v4"),
    AtariSpec("atari_amidar", "AmidarNoFrameskip-v4"),
    AtariSpec("atari_assault", "AssaultNoFrameskip-v4"),
    AtariSpec("atari_asterix", "AsterixNoFrameskip-v4"),
    AtariSpec("atari_asteroid", "AsteroidsNoFrameskip-v4"),
    AtariSpec("atari_atlantis", "AtlantisNoFrameskip-v4"),
    AtariSpec("atari_bankheist", "BankHeistNoFrameskip-v4"),
    AtariSpec("atari_battlezone", "BattleZoneNoFrameskip-v4"),
    AtariSpec("atari_beamrider", "BeamRiderNoFrameskip-v4"),
    AtariSpec("atari_berzerk", "BerzerkNoFrameskip-v4"),
    AtariSpec("atari_bowling", "BowlingNoFrameskip-v4"),
    AtariSpec("atari_boxing", "BoxingNoFrameskip-v4"),
    AtariSpec("atari_breakout", "BreakoutNoFrameskip-v4"),
    AtariSpec("atari_centipede", "CentipedeNoFrameskip-v4"),
    AtariSpec("atari_choppercommand", "ChopperCommandNoFrameskip-v4"),
    AtariSpec("atari_crazyclimber", "CrazyClimberNoFrameskip-v4"),
    AtariSpec("atari_defender", "DefenderNoFrameskip-v4"),
    AtariSpec("atari_demonattack", "DemonAttackNoFrameskip-v4"),
    AtariSpec("atari_doubledunk", "DoubleDunkNoFrameskip-v4"),
    AtariSpec("atari_enduro", "EnduroNoFrameskip-v4"),
    AtariSpec("atari_fishingderby", "FishingDerbyNoFrameskip-v4"),
    AtariSpec("atari_freeway", "FreewayNoFrameskip-v4"),
    AtariSpec("atari_frostbite", "FrostbiteNoFrameskip-v4"),
    AtariSpec("atari_gopher", "GopherNoFrameskip-v4"),
    AtariSpec("atari_gravitar", "GravitarNoFrameskip-v4"),
    AtariSpec("atari_hero", "HeroNoFrameskip-v4"),
    AtariSpec("atari_icehockey", "IceHockeyNoFrameskip-v4"),
    AtariSpec("atari_jamesbond", "JamesbondNoFrameskip-v4"),
    AtariSpec("atari_kangaroo", "KangarooNoFrameskip-v4"),
    AtariSpec("atari_krull", "KrullNoFrameskip-v4"),
    AtariSpec("atari_kongfumaster", "KungFuMasterNoFrameskip-v4"),
    AtariSpec("atari_montezuma", "MontezumaRevengeNoFrameskip-v4", default_timeout=18000),
    AtariSpec("atari_mspacman", "MsPacmanNoFrameskip-v4"),
    AtariSpec("atari_namethisgame", "NameThisGameNoFrameskip-v4"),
    AtariSpec("atari_phoenix", "PhoenixNoFrameskip-v4"),
    AtariSpec("atari_pitfall", "PitfallNoFrameskip-v4"),
    AtariSpec("atari_pong", "PongNoFrameskip-v4"),
    AtariSpec("atari_privateye", "PrivateEyeNoFrameskip-v4"),
    AtariSpec("atari_qbert", "QbertNoFrameskip-v4"),
    AtariSpec("atari_riverraid", "RiverraidNoFrameskip-v4"),
    AtariSpec("atari_roadrunner", "RoadRunnerNoFrameskip-v4"),
    AtariSpec("atari_robotank", "RobotankNoFrameskip-v4"),
    AtariSpec("atari_seaquest", "SeaquestNoFrameskip-v4"),
    AtariSpec("atari_skiing", "SkiingNoFrameskip-v4"),
    AtariSpec("atari_solaris", "SolarisNoFrameskip-v4"),
    AtariSpec("atari_spaceinvaders", "SpaceInvadersNoFrameskip-v4"),
    AtariSpec("atari_stargunner", "StarGunnerNoFrameskip-v4"),
    AtariSpec("atari_surround", "SurroundNoFrameskip-v4"),
    AtariSpec("atari_tennis", "TennisNoFrameskip-v4"),
    AtariSpec("atari_timepilot", "TimePilotNoFrameskip-v4"),
    AtariSpec("atari_tutankham", "TutankhamNoFrameskip-v4"),
    AtariSpec("atari_upndown", "UpNDownNoFrameskip-v4"),
    AtariSpec("atari_venture", "VentureNoFrameskip-v4"),
    AtariSpec("atari_videopinball", "VideoPinballNoFrameskip-v4"),
    AtariSpec("atari_wizardofwor", "WizardOfWorNoFrameskip-v4"),
    AtariSpec("atari_yarsrevenge", "YarsRevengeNoFrameskip-v4"),
    AtariSpec("atari_zaxxon", "ZaxxonNoFrameskip-v4"),
]


def atari_env_by_name(name: str) -> AtariSpec:
    for spec in ATARI_ENVS:
        if spec.name == name:
            return spec
    raise ValueError(f"Unknown Atari env {name}")


# ---------------------------------------------------- DeepMind-style wrappers


class NoopResetEnv(gym.Wrapper if gym else object):
    """Random number of no-ops after reset (published DeepMind preprocessing)."""

    def __init__(self, env, noop_max: int = 30):
        super().__init__(env)
        self.noop_max = noop_max
        assert env.unwrapped.get_action_meanings()[0] == "NOOP"

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = self.unwrapped.np_random.integers(1, self.noop_max + 1)
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        return obs, info


class MaxAndSkipEnv(gym.Wrapper if gym else object):
    """Frameskip with max-pooling over the last two frames."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self._obs_buffer = np.zeros((2,) + env.observation_space.shape, dtype=np.uint8)
        self._skip = skip
        self._sf_handles_frameskip = True

    def step(self, action):
        total_reward = 0.0
        terminated = truncated = False
        info = {}
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += reward
            if terminated or truncated:
                break
        return self._obs_buffer.max(axis=0), total_reward, terminated, truncated, info


class EpisodicLifeEnv(gym.Wrapper if gym else object):
    """Life loss terminates the episode for the value function; real reset only
    at true game over."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class FireResetEnv(gym.Wrapper if gym else object):
    """Press FIRE after reset for games that require it."""

    def __init__(self, env):
        super().__init__(env)
        assert env.unwrapped.get_action_meanings()[1] == "FIRE"

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, terminated, truncated, _ = self.env.step(1)
        if terminated or truncated:
            self.env.reset(**kwargs)
        obs, _, terminated, truncated, _ = self.env.step(2)
        if terminated or truncated:
            self.env.reset(**kwargs)
        return obs, {}


class ClipRewardEnv(gym.RewardWrapper if gym else object):
    def reward(self, reward):
        return float(np.sign(reward))


class FrameStackHWC(gym.ObservationWrapper if gym else object):
    """Stack k grayscale frames into the channel dim (HWC, the encoders' layout)."""

    def __init__(self, env, k: int):
        super().__init__(env)
        self.k = k
        h, w = env.observation_space.shape[:2]
        self.frames = np.zeros((h, w, k), dtype=np.uint8)
        self.observation_space = gym.spaces.Box(0, 255, (h, w, k), dtype=np.uint8)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        frame = obs if obs.ndim == 2 else obs[..., 0]
        for i in range(self.k):
            self.frames[..., i] = frame
        return self.frames.copy(), info

    def observation(self, obs):
        frame = obs if obs.ndim == 2 else obs[..., 0]
        self.frames = np.roll(self.frames, shift=-1, axis=-1)
        self.frames[..., -1] = frame
        return self.frames.copy()


def make_atari_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not atari_available():
        raise RuntimeError("Atari requires ale_py; pip install sample-factory-tpu[atari]")
    import ale_py  # noqa: F401

    gym.register_envs(ale_py)
    spec = atari_env_by_name(env_name)
    env = gym.make(spec.env_id, render_mode=render_mode)
    if spec.default_timeout is not None:
        env._max_episode_steps = spec.default_timeout

    env = gym.wrappers.RecordEpisodeStatistics(env)
    env = NoopResetEnv(env, noop_max=30)
    env = MaxAndSkipEnv(env, skip=cfg.env_frameskip if cfg else 4)
    env = EpisodicLifeEnv(env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    env = ClipRewardEnv(env)
    env = gym.wrappers.ResizeObservation(env, (84, 84))
    env = gym.wrappers.GrayscaleObservation(env)
    env = FrameStackHWC(env, cfg.env_framestack if cfg else 4)
    return env


def register_atari_components() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for spec in ATARI_ENVS:
        register_env(spec.name, make_atari_env)
