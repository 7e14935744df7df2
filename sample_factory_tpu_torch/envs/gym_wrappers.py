"""Host (gymnasium) env wrappers and creation.

Copy of `sample_factory_tpu/envs/gym_wrappers.py` (reference
`sample_factory/envs/env_wrappers.py`: pixel format, resize, frameskip, episode
counters; `sample_factory/algo/utils/make_env.py`: dict-obs normalization).
Observations stay HWC uint8 on the host, the trajectory's layout in both
packages (the port's conv encoder permutes to NCHW itself), and the vector
dimension is assembled by the host sampler, not by nested wrapper stacks.
The module imports without gymnasium; the wrappers need it when used.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None

from sample_factory_tpu_torch.envs.spaces import DictSpec
from sample_factory_tpu_torch.utils.utils import log


class DictObservationWrapper(gym.ObservationWrapper if gym else object):
    """Wrap a non-dict observation space into {'obs': ...} (reference make_env.py:59-77)."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = gym.spaces.Dict({"obs": env.observation_space})

    def observation(self, obs):
        return {"obs": obs}


class ImageToHWC(gym.ObservationWrapper if gym else object):
    """Ensure image observations are channel-last (the trajectory's layout)."""

    def __init__(self, env):
        super().__init__(env)
        old = env.observation_space
        assert isinstance(old, gym.spaces.Box) and len(old.shape) == 3
        if old.shape[0] <= 4 and old.shape[0] < old.shape[-1]:
            # CHW -> HWC
            self._transpose = True
            new_shape = (old.shape[1], old.shape[2], old.shape[0])
            self.observation_space = gym.spaces.Box(
                low=old.low.min(), high=old.high.max(), shape=new_shape, dtype=old.dtype
            )
        else:
            self._transpose = False
            self.observation_space = old

    def observation(self, obs):
        return np.transpose(obs, (1, 2, 0)) if self._transpose else obs


class FrameskipWrapper(gym.Wrapper if gym else object):
    """Action repeat with reward accumulation (reference env_wrappers.py SkipFramesWrapper)."""

    def __init__(self, env, skip: int):
        super().__init__(env)
        self.skip = skip

    def step(self, action):
        total_reward = 0.0
        obs = reward = terminated = truncated = info = None
        for _ in range(self.skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total_reward += reward
            if terminated or truncated:
                break
        return obs, total_reward, terminated, truncated, info


class ResizeWrapper(gym.ObservationWrapper if gym else object):
    """Resize image observations to (h, w) (reference env_wrappers.py:25-88).

    Uses cv2 when available (same as the reference), otherwise a strided
    nearest-neighbour fallback so pixel envs work in cv2-less installs.
    """

    def __init__(self, env, w: int, h: int, grayscale: bool = False, add_channel_dim: bool = False):
        super().__init__(env)
        self.w, self.h = int(w), int(h)
        self.grayscale = grayscale
        self.add_channel_dim = add_channel_dim
        old = env.observation_space
        assert isinstance(old, gym.spaces.Box) and len(old.shape) >= 2, old
        if grayscale:
            channels = 1 if add_channel_dim else None
        else:
            channels = old.shape[2] if len(old.shape) == 3 else (1 if add_channel_dim else None)
        shape = (self.h, self.w) if channels is None else (self.h, self.w, channels)
        self.observation_space = gym.spaces.Box(0, 255, shape, dtype=old.dtype)

    def observation(self, obs):
        obs = np.asarray(obs)
        try:
            import cv2

            out = cv2.resize(obs, (self.w, self.h), interpolation=cv2.INTER_AREA)
            if self.grayscale and out.ndim == 3 and out.shape[-1] == 3:
                out = cv2.cvtColor(out, cv2.COLOR_RGB2GRAY)
        except ImportError:
            ys = (np.linspace(0, obs.shape[0] - 1, self.h)).astype(np.int64)
            xs = (np.linspace(0, obs.shape[1] - 1, self.w)).astype(np.int64)
            out = obs[ys][:, xs]
            if self.grayscale and out.ndim == 3 and out.shape[-1] == 3:
                out = out.mean(axis=-1).astype(obs.dtype)
        if out.ndim == 2 and self.add_channel_dim:
            out = out[:, :, None]
        return out


class RewardScalingWrapper(gym.RewardWrapper if gym else object):
    """Multiply env rewards by a constant (reference env_wrappers.py:91-99)."""

    def __init__(self, env, scale: float):
        super().__init__(env)
        self._scale = float(scale)

    def reward(self, reward):
        return reward * self._scale


class TimeLimitWrapper(gym.Wrapper if gym else object):
    """Truncate episodes after `limit` steps, optionally with a random
    per-episode variation to decorrelate resets across a vectorized fleet
    (reference env_wrappers.py:101-129). Sets info["time_outs"]=True on
    truncation so the learner can bootstrap the value (value_bootstrap)."""

    def __init__(self, env, limit: int, random_variation_steps: int = 0):
        super().__init__(env)
        self._limit = int(limit)
        self._variation = int(random_variation_steps)
        self._steps = 0
        self._rng = np.random.default_rng()
        self._terminate_in = self._sample_limit()

    def _sample_limit(self) -> int:
        if self._variation == 0:
            return self._limit
        return int(self._limit + self._rng.integers(-self._variation, self._variation + 1))

    def reset(self, **kwargs):
        self._steps = 0
        self._terminate_in = self._sample_limit()
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._steps += getattr(self.env.unwrapped, "skip_frames", 1)
        if self._steps >= self._terminate_in and not terminated:
            truncated = True
            info["time_outs"] = True
        return obs, reward, terminated, truncated, info


class RecordingWrapper(gym.Wrapper if gym else object):
    """Save every frame of every episode as images under record_to/ep_XXX
    (reference env_wrappers.py:194-268). Also writes episode reward into the
    directory name on completion so recordings are self-describing."""

    def __init__(self, env, record_to: str, player_id=None):
        super().__init__(env)
        import os

        self._record_to = record_to
        self._player_id = player_id
        self._episode = 0
        self._frame = 0
        self._reward = 0.0
        self._dir = None
        os.makedirs(record_to, exist_ok=True)

    def _new_episode_dir(self):
        import os

        suffix = f"_p{self._player_id}" if self._player_id is not None else ""
        self._dir = f"{self._record_to}/ep_{self._episode:04d}{suffix}"
        os.makedirs(self._dir, exist_ok=True)
        self._frame = 0
        self._reward = 0.0

    def _save_frame(self, obs):
        img = obs["obs"] if isinstance(obs, dict) else obs
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[-1] not in (1, 3):
            return
        try:
            import cv2

            cv2.imwrite(f"{self._dir}/frame_{self._frame:06d}.png", img[..., ::-1])
        except ImportError:
            np.save(f"{self._dir}/frame_{self._frame:06d}.npy", img)
        self._frame += 1

    def reset(self, **kwargs):
        import os

        if self._dir is not None and self._frame > 0:
            finished = f"{self._dir}_r{self._reward:.1f}"
            if not os.path.exists(finished):
                os.rename(self._dir, finished)
        obs, info = self.env.reset(**kwargs)
        self._new_episode_dir()
        self._episode += 1
        self._save_frame(obs)
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._reward += float(np.sum(reward))
        self._save_frame(obs)
        return obs, reward, terminated, truncated, info


class EpisodeCounterWrapper(gym.Wrapper if gym else object):
    def __init__(self, env):
        super().__init__(env)
        self.episode_count = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        if terminated or truncated:
            self.episode_count += 1
        return obs, reward, terminated, truncated, info


def wrap_host_env(env, cfg):
    """Standard wrapper stack for host envs (reference create_env + make_env).

    An env that repeats its actions itself says so with `_sf_handles_frameskip`, on itself or
    on the base env under its gymnasium wrappers (gymnasium's wrappers do not forward the
    attribute: the JAX package misses it there and repeats a Doom env's actions twice). An env
    whose observation space is already one of the port's `DictSpec`s gets no layout wrapper,
    so that it runs without gymnasium."""
    handles_frameskip = getattr(env, "_sf_handles_frameskip", False) or getattr(
        getattr(env, "unwrapped", env), "_sf_handles_frameskip", False
    )
    if cfg is not None and cfg.env_frameskip > 1 and not handles_frameskip:
        env = FrameskipWrapper(env, cfg.env_frameskip)
    own_spec = isinstance(env.observation_space, DictSpec)
    if not own_spec and isinstance(env.observation_space, gym.spaces.Box) and len(env.observation_space.shape) == 3:
        env = ImageToHWC(env)
    if cfg is not None and cfg.use_record_episode_statistics:
        env = gym.wrappers.RecordEpisodeStatistics(env)
    if cfg is not None and cfg.episode_counter:
        env = EpisodeCounterWrapper(env)
    if not own_spec and not isinstance(env.observation_space, gym.spaces.Dict):
        env = DictObservationWrapper(env)
    return env
