"""A seeded device env of IsaacGymEnvs' AllegroHand widths, with no physics: the trainer's traffic alone.

88 float32 observations (the task's "states" vector) clipped to +-5, 16 actions clipped to +-1, episodes of 600 steps.
The state moves with the action through a fixed random linear map, with noise from the run's generator; the reward is
a function of the action and the state: the mean square distance of the action from tanh of the first 16 states, so
that a policy has something to learn. The first reset of an env instance starts every episode at a seeded offset in
[0, episode_len) of its clock, so that resets fall mid-segment from the first rollout on, as in IsaacGym's vectorised
tasks after their first episodes; every later reset starts the clock at 0.
"""

from __future__ import annotations

import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, make_dict_spec


class AllegroStatesEnv(DeviceEnv):
    def __init__(self, obs_dim: int = 88, num_actions: int = 16, episode_len: int = 600, obs_clip: float = 5.0,
                 decay: float = 0.95, action_gain: float = 0.3, noise: float = 0.1, dynamics_seed: int = 1):
        self.obs_dim, self.num_actions, self.episode_len, self.obs_clip = obs_dim, num_actions, episode_len, obs_clip
        self.decay, self.action_gain, self.noise = decay, action_gain, noise
        self.obs_space = make_dict_spec({"obs": Box((obs_dim,), -obs_clip, obs_clip)})
        self.action_space = Box((num_actions,), -1.0, 1.0)
        g = torch.Generator().manual_seed(dynamics_seed)
        self._mix_cpu = torch.randn((num_actions, obs_dim), generator=g) / num_actions**0.5
        self._mix = {}
        self._staggered = False

    def _mix_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._mix:
            self._mix[key] = self._mix_cpu.to(device)
        return self._mix[key]

    def reset_draws(self, num_envs, generator, device):
        draws = {"x": torch.randn((num_envs, self.obs_dim), generator=generator, device=device)}
        if not self._staggered:
            draws["clock"] = torch.randint(0, self.episode_len, (num_envs,), generator=generator, device=device)
            self._staggered = True
        return draws

    def step_draws(self, num_envs, generator, device):
        return {"noise": torch.randn((num_envs, self.obs_dim), generator=generator, device=device)}

    def _reset(self, num_envs, device, draws):
        x = draws["x"].to(device).clamp(-self.obs_clip, self.obs_clip)
        clock = draws.get("clock")
        steps = torch.zeros((num_envs,), dtype=torch.int64, device=device) if clock is None else clock.to(device)
        return {"obs": x}, {"x": x, "steps": steps}

    def _step(self, state, actions, draws, shaping):
        a = actions.float().clamp(-1.0, 1.0)
        x = state["x"]
        target = torch.tanh(x[:, : self.num_actions])
        reward = -(a - target).square().mean(dim=-1)
        x = (self.decay * x + self.action_gain * (a @ self._mix_on(x.device)) + self.noise * draws["noise"]).clamp(
            -self.obs_clip, self.obs_clip)
        steps = state["steps"] + 1
        terminated = torch.zeros_like(steps, dtype=torch.bool)
        truncated = steps >= self.episode_len
        return {"obs": x}, {"x": x, "steps": steps}, reward, terminated, truncated, {}


def make_env(params) -> AllegroStatesEnv:
    return AllegroStatesEnv(**params)
