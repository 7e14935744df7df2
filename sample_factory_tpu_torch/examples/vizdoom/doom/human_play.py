"""Human-input play for Doom scenarios.

Copy of `sf_examples_tpu/vizdoom/doom/human_play.py` (reference
`sf_examples/vizdoom/doom/wrappers/step_human_input.py`, StepHumanInput, and `play_doom.py`,
the interactive session). The env switches to
the engine's ASYNC_SPECTATOR mode; each step() ignores the policy action and
advances one engine tic driven by the keyboard."""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None


class StepHumanInput(gym.Wrapper if gym else object):
    """Wrapper that replaces policy actions with keyboard input."""

    def __init__(self, env):
        super().__init__(env)

    def _to_human(self):
        root = self.env.unwrapped
        if root.mode != "human":
            root.mode = "human"
            if root.initialized:
                root.close()
                root.initialized = False
        root._ensure_initialized()
        return root

    def reset(self, **kwargs):
        self._to_human()
        return self.env.reset(**kwargs)

    def step(self, action):
        del action  # keyboard drives the game
        root = self._to_human()
        obs, reward, terminated = root.advance_human_or_replay()
        return obs, reward, terminated, False, {}


def play_human(env, max_episodes: int = 1) -> float:
    """Interactive loop: reset, advance on keyboard input, report returns."""
    from sample_factory_tpu_torch.utils.utils import log

    env = StepHumanInput(env)
    total = 0.0
    for ep in range(max_episodes):
        env.reset()
        ep_ret, done = 0.0, False
        while not done:
            _obs, r, done, _trunc, _info = env.step(np.zeros(1))
            ep_ret += float(r)
        log.info("Episode %d finished, return %.1f", ep, ep_ret)
        total += ep_ret
    env.close()
    return total / max(1, max_episodes)
