"""Batched host vector env contract, a vectorized CartPole and a synthetic pixel env.

Counterpart of `sample_factory_tpu/envs/batched_host_env.py` (reference
`algo/sampling/batched_sampling.py:298-392`): one env object steps a whole
batch as numpy arrays (the contract envpool and IsaacGym-style CPU vector envs
implement). The host sampler (`algo/host_sampling.py`, `EnvSlotStepper`) gives
such an env one instance per worker-split, sized via `env_config.num_envs`,
and steps it with a single array call: no per-env Python loop between the env
and the shared-memory slabs.

Protocol (duck-typed; subclassing BatchedHostEnv is optional):
  - `is_batched_vector_env = True`, `num_envs: int`
  - `observation_space` / `action_space`: PER-ENV spaces, gymnasium's or the
    port's own specs (`envs/spaces.py`); the envs here declare the latter, so
    that they run where gymnasium is not installed
  - `reset(seed=None) -> (obs[N, ...], info)`
  - `step(actions[N, ...]) -> (obs, rewards[N], terminated[N], truncated[N], infos)`
    with AUTO-RESET semantics: for done envs the returned obs is the next
    episode's first observation (the reference's BatchedVecEnv convention).
    `infos` may carry per-env arrays (e.g. "time_outs") and an optional
    "episode_extra_stats" list of dicts.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Box, Discrete


class BatchedHostEnv:
    """Base class for batched host vector envs (see module docstring)."""

    is_batched_vector_env = True
    gymnasium_api = True  # already presents the gymnasium 5-tuple contract

    def __init__(self, num_envs: int):
        self.num_envs = int(num_envs)

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError

    def close(self) -> None:
        pass


class BatchedCartPoleEnv(BatchedHostEnv):
    """Numpy-vectorized cart-pole, auto-resetting. Standard Barto-Sutton-Anderson dynamics
    (same constants as the device CartPoleEnv, envs/builtin/classic_control.py): a
    dependency-free stand-in for envpool in tests of the host pipeline."""

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masscart + masspole
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * np.pi / 360
    x_threshold = 2.4
    max_steps = 500

    def __init__(self, num_envs: int, seed: int = 0):
        super().__init__(num_envs)
        self.observation_space = Box((4,), -math.inf, math.inf, "float32")
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(seed)
        self._s = np.zeros((num_envs, 4), np.float32)
        self._steps = np.zeros(num_envs, np.int64)

    def _sample_states(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._s = self._sample_states(self.num_envs)
        self._steps[:] = 0
        return self._s.copy(), {}

    def step(self, actions: np.ndarray):
        a = np.asarray(actions).reshape(self.num_envs).astype(np.int64)
        x, x_dot, theta, theta_dot = self._s[:, 0], self._s[:, 1], self._s[:, 2], self._s[:, 3]
        force = np.where(a == 1, self.force_mag, -self.force_mag)

        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass

        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._s = np.stack([x, x_dot, theta, theta_dot], axis=1).astype(np.float32)
        self._steps += 1

        terminated = (np.abs(x) > self.x_threshold) | (np.abs(theta) > self.theta_threshold)
        truncated = (~terminated) & (self._steps >= self.max_steps)
        rewards = np.ones(self.num_envs, np.float32)

        done = terminated | truncated
        if done.any():
            n = int(done.sum())
            self._s[done] = self._sample_states(n)
            self._steps[done] = 0
        return self._s.copy(), rewards, terminated, truncated, {}


def _split_size(env_config) -> int:
    """The split's size for a worker's instance, 1 for the probe instance."""
    if env_config is not None and getattr(env_config, "num_envs", None):
        return int(env_config.num_envs)
    return 1


def make_batched_cartpole(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    seed = (cfg.seed or 0) if cfg is not None else 0
    if env_config is not None:
        seed += int(getattr(env_config, "env_id", 0) or 0)
    return BatchedCartPoleEnv(_split_size(env_config), seed=seed)


def register_batched_cartpole(env_name: str = "batched_cartpole") -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env(env_name, make_batched_cartpole)


class BenchPixelBatchedEnv(BatchedHostEnv):
    """Synthetic batched uint8 pixel env (an envpool/ViZDoom feeding proxy; counterpart of
    `bench.py:434-474`, `_BenchPixelBatchedEnv`): one array call per split and near-zero env
    cost, so that a run shows the host feeding machinery alone: worker processes, the
    shared-memory slabs, the uint8 host-to-device upload, inference and the quantized learner.
    42x42x4 uint8 frames, 6 actions, reward 1 a step, episodes of 512 steps."""

    episode_len = 512

    def __init__(self, num_envs: int, res: int = 42, stack: int = 4):
        super().__init__(num_envs)
        self.observation_space = Box((res, res, stack), 0, 255, "uint8")
        self.action_space = Discrete(6)
        self._obs = np.random.default_rng(0).integers(0, 255, (num_envs, res, res, stack), dtype=np.uint8)
        self.t = np.zeros(num_envs, np.int64)

    def reset(self, seed: Optional[int] = None):
        self.t[:] = 0
        return self._obs, {}

    def step(self, actions: np.ndarray):
        self.t += 1
        # cheap content mutation so that no two uploads are alike
        self._obs[:, 0, 0, 0] = (self.t % 251).astype(np.uint8)
        done = self.t >= self.episode_len
        self.t[done] = 0
        return self._obs, np.ones(self.num_envs, np.float32), done, np.zeros(self.num_envs, bool), {}


def make_bench_pixel_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    return BenchPixelBatchedEnv(_split_size(env_config))


def register_bench_pixel(env_name: str = "bench_host_pixel") -> None:
    """Module-level, so that a spawned worker can import and call it (`register_fn`)."""
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env(env_name, make_bench_pixel_env)
