"""A seeded device env of two observation keys, for the test configuration `two_key`: `obs`, uint8 frames
[size, size, 3] of noise drawn each step, and `tokens`, int32 ids in [1, vocab) with trailing zeros (padding), drawn
at each reset and held through the episode. The reward is 1 where the action is the first token's id modulo the
number of actions. Episodes last `episode_len` steps; the first reset of an instance staggers their clocks."""

from __future__ import annotations

import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec


class TwoKeyEnv(DeviceEnv):
    def __init__(self, size: int = 24, tokens: int = 8, vocab: int = 31, num_actions: int = 4, episode_len: int = 20):
        self.size, self.tokens, self.vocab, self.num_actions = size, tokens, vocab, num_actions
        self.episode_len = episode_len
        self.obs_space = make_dict_spec({"obs": Box((size, size, 3), 0, 255, dtype="uint8"),
                                         "tokens": Box((tokens,), 0, vocab - 1, dtype="int32")})
        self.action_space = Discrete(num_actions)
        self._staggered = False

    def reset_draws(self, num_envs, generator, device):
        draws = {"ids": torch.randint(1, self.vocab, (num_envs, self.tokens), generator=generator, device=device),
                 "length": torch.randint(1, self.tokens + 1, (num_envs, 1), generator=generator, device=device),
                 **self.step_draws(num_envs, generator, device)}
        if not self._staggered:
            draws["clock"] = torch.randint(0, self.episode_len, (num_envs,), generator=generator, device=device)
            self._staggered = True
        return draws

    def step_draws(self, num_envs, generator, device):
        return {"frame": torch.randint(0, 256, (num_envs, self.size, self.size, 3), generator=generator, device=device)}

    def _reset(self, num_envs, device, draws):
        positions = torch.arange(self.tokens, device=device)[None]
        tokens = torch.where(positions < draws["length"].to(device), draws["ids"].to(device), 0).to(torch.int32)
        clock = draws.get("clock")
        steps = torch.zeros((num_envs,), dtype=torch.int64, device=device) if clock is None else clock.to(device)
        return {"obs": draws["frame"].to(device, torch.uint8), "tokens": tokens}, {"tokens": tokens, "steps": steps}

    def _step(self, state, actions, draws, shaping):
        a = actions.reshape(-1).long()
        reward = (a == state["tokens"][:, 0].long() % self.num_actions).float()
        steps = state["steps"] + 1
        truncated = steps >= self.episode_len
        obs = {"obs": draws["frame"].to(a.device, torch.uint8), "tokens": state["tokens"]}
        return obs, {"tokens": state["tokens"], "steps": steps}, reward, torch.zeros_like(truncated), truncated, {}


def make_env(params) -> TwoKeyEnv:
    return TwoKeyEnv(**params)
