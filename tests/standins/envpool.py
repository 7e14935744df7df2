"""A stand-in for envpool's Atari pools, for machines without envpool: CHW uint8 frames
(4, 84, 84) from a seeded generator, Discrete(6), and envpool's semantics (the terminal frame at
done; `reset(env_ids)` starts those envs' next episodes). Spaces in the port's specs.

`chip_smoke.py` and `tests/test_torch_atari.py` put this directory on `sys.path` and `PYTHONPATH`
(spawned workers import it too), so that `import envpool` finds this module."""

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Box, Discrete


class AtariPool:
    def __init__(self, task_id, num_envs, seed, max_episode_steps=27000):
        self.task_id, self.num_envs, self.limit = task_id, num_envs, max_episode_steps
        self.observation_space = Box((4, 84, 84), 0.0, 255.0, "uint8")
        self.action_space = Discrete(6)
        self.rng = np.random.default_rng(seed)
        self.t = np.zeros(num_envs, np.int64)
        self.length = self.rng.integers(16, 400, num_envs)

    def _frames(self, n):
        return self.rng.integers(0, 256, (n, 4, 84, 84), dtype=np.uint8)

    def reset(self, env_ids=None):
        ids = np.arange(self.num_envs) if env_ids is None else np.asarray(env_ids)
        self.t[ids] = 0
        self.length[ids] = self.rng.integers(16, 400, len(ids))
        return self._frames(len(ids)), {}

    def step(self, actions):
        assert len(actions) == self.num_envs
        self.t += 1
        rewards = (np.asarray(actions) == self.t % 6).astype(np.float32)
        terminated = self.t >= self.length
        truncated = ~terminated & (self.t >= self.limit)
        return self._frames(self.num_envs), rewards, terminated, truncated, {}

    def close(self):
        pass


def make(task_id, env_type, num_envs, seed, **kwargs):
    assert env_type == "gymnasium"
    return AtariPool(task_id, num_envs, seed, **kwargs)
