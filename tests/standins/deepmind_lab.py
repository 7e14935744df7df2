"""A stand-in for DeepMind Lab's `deepmind_lab` module, for machines without it: neither the CPU
test machine nor the card's machine has the engine (or its levels). The DMLab env of the JAX
package and of the port are held against each other over it, and `chip_smoke.py` drives the
port's real env module over it.

`Lab(level, observations, config, renderer, level_cache)` with `reset(seed)`, `observations()`,
`step(action, num_steps)`, `is_running()` and `close()`. Everything follows from the level name and
the reset seed: `RGB_INTERLEAVED` [height, width, 3] uint8 (the episode's noise image shifted by
the frame), an `INSTR` string of 0 to 20 words from a small word list (so empty, full and
truncated instructions all occur), the episode's length in frames, and the rewards (mostly 0,
sometimes a positive or negative number, plus a term in the action). With a `level_cache`, `reset`
calls its hooks as the engine does when it builds a map: `fetch(key, pk3_path)`, and on a miss
writes the generated map to `pk3_path` and calls `write(key, pk3_path)`. Put this directory on
`sys.path` (and `PYTHONPATH` for spawned workers) so that `import deepmind_lab` finds it.
"""

import os
import shutil
import tempfile
import zlib

import numpy as np

WORDS = ("pick", "the", "red", "green", "blue", "object", "key", "door", "balloon", "hat", "car", "apple", "left", "right",
         "room", "find", "collect", "large", "small", "near", "far", "is", "what", "color", "how", "many")
OBSERVATIONS = ("RGB_INTERLEAVED", "INSTR")


class Lab:
    def __init__(self, level, observations, config=None, renderer="software", level_cache=None):
        unknown = [o for o in observations if o not in OBSERVATIONS]
        if unknown:
            raise ValueError(f"unknown observations {unknown}")
        config = config or {}
        self.level, self.observation_names, self.renderer = level, list(observations), renderer
        self.width, self.height = int(config.get("width", 96)), int(config.get("height", 72))
        self.level_cache = level_cache
        self._level_key = zlib.crc32(level.encode())
        self._tmp = tempfile.mkdtemp(prefix="dmlab_standin_")
        self._frames_left = 0

    def reset(self, seed=None, episode=-1):
        rng = np.random.default_rng([self._level_key, int(seed or 0)])
        if self.level_cache is not None:
            key = f"{self._level_key:08x}_{int(seed or 0)}"
            pk3_path = os.path.join(self._tmp, key + ".pk3")
            if not self.level_cache.fetch(key, pk3_path):
                with open(pk3_path, "wb") as f:
                    f.write(rng.bytes(256))  # the generated map
                self.level_cache.write(key, pk3_path)
        self._rng = rng
        self._frames_left = int(rng.integers(100, 800))
        self._frame = 0
        self._image = rng.integers(0, 256, (self.height, self.width, 3), dtype=np.uint8)
        words = rng.choice(len(WORDS), int(rng.integers(0, 21)))
        self._instr = " ".join(WORDS[i] for i in words)
        return True

    def observations(self):
        out = {"RGB_INTERLEAVED": self._image + np.uint8(self._frame % 256)}
        if "INSTR" in self.observation_names:
            out["INSTR"] = self._instr
        return out

    def step(self, action, num_steps=1):
        action = np.asarray(action)
        if action.shape != (7,):
            raise ValueError(f"a DMLab action has 7 values, got {action.shape}")
        reward = 0.0
        for _ in range(num_steps):
            u = self._rng.random()
            reward += 10.0 * (u - 0.97) / 0.03 if u > 0.97 else (-2.0 if u < 0.01 else 0.0)
        reward += 0.1 * float(action[3])  # moving forward pays a little
        self._frame += num_steps
        self._frames_left -= num_steps
        return reward

    def is_running(self):
        return self._frames_left > 0

    def close(self):
        shutil.rmtree(self._tmp, ignore_errors=True)
