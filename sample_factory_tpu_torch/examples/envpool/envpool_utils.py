"""EnvPool integration: batched C++ env stepping feeding the host pipeline.

Copy of `sf_examples_tpu/envpool/envpool_utils.py` (reference `sf_examples/envpool/`:
envpool as the high-performance batched CPU env backend). An envpool instance steps a
whole batch in C++ threads, so it plugs into the host sampler's batched vector-env
contract (`envs/batched_host_env.py`): one pool per worker-split, sized via
env_config.num_envs, stepped with a single array call straight into the shared-memory
slabs. Gated on envpool availability. The transposed observation space is declared in
the port's own specs, so the adapter needs no gymnasium over a pool that declares its
spaces in them.

Env name convention: ``envpool_<TaskId>`` (e.g. ``envpool_Breakout-v5``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Box, from_gym_space


def envpool_available() -> bool:
    try:
        import envpool  # noqa: F401

        return True
    except ImportError:
        return False


class EnvPoolBatchedEnv:
    """Adapter presenting the batched host vector-env contract over an
    envpool gymnasium-API pool (auto-reset; arrays in, arrays out).

    transpose_hwc: envpool image pools return CHW; the encoders are channel-last,
    so image observations are transposed to HWC at the adapter boundary (uint8,
    negligible host cost)."""

    is_batched_vector_env = True
    gymnasium_api = True

    def __init__(self, task_id: str, num_envs: int, seed: int = 0, transpose_hwc: bool = False, **kwargs):
        import envpool

        self.pool = envpool.make(task_id, env_type="gymnasium", num_envs=num_envs, seed=seed, **kwargs)
        self.num_envs = int(num_envs)
        self.observation_space = self.pool.observation_space  # per-env space
        self.action_space = self.pool.action_space
        self._transpose = False
        if transpose_hwc and len(getattr(self.observation_space, "shape", ())) == 3:
            space = from_gym_space(self.observation_space)
            c, h, w = space.shape
            self._transpose = True
            self.observation_space = Box((h, w, c), space.low, space.high, space.dtype)

    def _maybe_hwc(self, obs):
        if self._transpose:
            return np.transpose(obs, (0, 2, 3, 1))
        return obs

    def reset(self, seed: Optional[int] = None):
        # envpool pools are seeded at construction; the gymnasium API returns
        # (obs[N, ...], info)
        out = self.pool.reset()
        if isinstance(out, tuple) and len(out) == 2:
            return self._maybe_hwc(out[0]), out[1]
        return self._maybe_hwc(out), {}

    def step(self, actions):
        obs, rewards, terminated, truncated, info = self.pool.step(np.asarray(actions))
        # envpool returns the TERMINAL obs on the done step and resets on the
        # NEXT step (ignoring that step's action); the batched contract wants
        # the next episode's first obs at done. Reset the done envs explicitly
        # (reference sf_examples/envpool/envpool_wrappers.py:28-38
        # EnvPoolResetFixWrapper does exactly this).
        needs_reset = np.nonzero(np.asarray(terminated) | np.asarray(truncated))[0]
        if needs_reset.size:
            reset_out = self.pool.reset(needs_reset)
            reset_obs = reset_out[0] if isinstance(reset_out, tuple) else reset_out
            if isinstance(obs, dict):
                for k in obs:
                    obs[k][needs_reset] = reset_obs[k]
            else:
                obs[needs_reset] = reset_obs
        return self._maybe_hwc(obs), rewards, terminated, truncated, info

    def close(self) -> None:
        try:
            self.pool.close()
        except Exception:  # noqa: BLE001 - some pool versions have no close()
            pass


def pool_size_and_seed(cfg=None, env_config=None):
    """(num_envs, seed) of the pool for one worker-split."""
    # pool size = split size, provided by the host sampler (EnvSlotStepper
    # passes env_config.num_envs); the env-info probe creates a 1-env pool
    num_envs = 1
    if env_config is not None and getattr(env_config, "num_envs", None):
        num_envs = int(env_config.num_envs)
    seed = (cfg.seed or 0) if cfg is not None else 0
    # env_seed_offset decorrelates episode streams across processes; pools are
    # seeded at construction only (EnvPoolBatchedEnv.reset ignores per-reset
    # seeds), so the offset must be folded in here
    seed += int(getattr(cfg, "env_seed_offset", 0) or 0) if cfg is not None else 0
    if env_config is not None:
        seed += int(getattr(env_config, "env_id", 0) or 0)
    return num_envs, seed


def make_envpool_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if not envpool_available():
        raise RuntimeError("envpool is not installed; pip install envpool")
    task_id = env_name.split("envpool_", 1)[1]
    num_envs, seed = pool_size_and_seed(cfg, env_config)
    return EnvPoolBatchedEnv(task_id, num_envs=num_envs, seed=seed)


def register_envpool_env(env_name: str) -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env(env_name, make_envpool_env)
