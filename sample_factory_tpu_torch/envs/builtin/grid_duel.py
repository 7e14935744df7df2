"""GridDuel: an on-device 2-agent self-play combat env, batched over N envs.

Counterpart of `sample_factory_tpu/envs/builtin/grid_duel.py`: two agents on
one grid shoot at each other, and each agent may be driven by a different
policy of the population (within-env policy mixing). The same rules, written
for the multi-agent contract of `envs/device_env.py`: obs `[N, 2, S, S, 3]`,
actions `[N, 2]` (or `[N, 2, 1]`), reward, terminated and truncated `[N, 2]`,
`info["active"]` `[N, 2]`, shaping coefficients as floats or `[N, 2]` tensors.

Observations are egocentric: each agent sees itself in channel 0, the
opponent in channel 1 and its own health in row 0 of channel 2, so one policy
network serves either seat.
"""

from __future__ import annotations

import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec

# actions: 0..3 move NSEW, 4 shoot, 5 idle
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0), (0, 0))


class GridDuelEnv(DeviceEnv):
    num_agents = 2

    def __init__(self, size: int = 16, episode_len: int = 256, shoot_range: int = 6, health: float = 3.0):
        self.size = size
        self.episode_len = episode_len
        self.shoot_range = shoot_range
        self.max_health = health
        self.obs_space = make_dict_spec({"obs": Box((size, size, 3), 0.0, 1.0)})
        self.action_space = Discrete(6)
        self.reward_shaping = {"hit_reward": 1.0, "hit_penalty": 0.5, "win_reward": 2.0}
        self.supports_dynamic_shaping = True

    def reset_draws(self, num_envs, generator, device):
        """Spawn offsets of the two agents, each within its own corner third (:73-75)."""
        q = self.size // 3
        return {
            "p0": torch.randint(0, q, (num_envs, 2), generator=generator, device=device),
            "p1": torch.randint(0, q, (num_envs, 2), generator=generator, device=device),
        }

    def _render_obs(self, state):
        """Egocentric images [N, 2, S, S, 3]."""
        pos, health = state["pos"], state["health"]
        n, S, device = pos.shape[0], self.size, pos.device
        img = torch.zeros((n, 2, S, S, 3), device=device)
        rows = torch.arange(n, device=device)[:, None].expand(n, 2)
        me = torch.arange(2, device=device)[None, :].expand(n, 2)
        other = pos.flip(1)
        img[rows, me, pos[..., 0], pos[..., 1], 0] = 1.0
        img[rows, me, other[..., 0], other[..., 1], 1] = 1.0
        cols = torch.arange(S, device=device)[None, None, :] < (health[..., None] * S / self.max_health)
        img[:, :, 0, :, 2] = cols.float()
        return {"obs": img}

    def _reset(self, num_envs, device, draws):
        p0 = draws["p0"].to(device=device, dtype=torch.int64)
        p1 = self.size - 1 - draws["p1"].to(device=device, dtype=torch.int64)
        state = {
            "pos": torch.stack([p0, p1], dim=1),
            "health": torch.full((num_envs, 2), self.max_health, device=device),
            "steps": torch.zeros((num_envs,), dtype=torch.int64, device=device),
        }
        return self._render_obs(state), state

    def _step(self, state, actions, draws, shaping):
        a = (actions[..., 0] if actions.dim() > 2 else actions).long()  # [N, 2]
        device = a.device
        moves = torch.tensor(MOVES, dtype=torch.int64, device=device)
        pos = (state["pos"] + moves[a]).clamp(0, self.size - 1)

        # simultaneous shots: agent i hits its opponent when it shoots and the opponent
        # stands in the same row or column within range
        diff = pos.flip(1) - pos  # [N, 2, 2]: opponent - self
        aligned = ((diff[..., 0] == 0) & (diff[..., 1].abs() <= self.shoot_range)) | (
            (diff[..., 1] == 0) & (diff[..., 0].abs() <= self.shoot_range)
        )
        hits = (a == 4) & aligned  # [N, 2]
        damage_taken = hits.flip(1).float()
        health = state["health"] - damage_taken

        dead = health <= 0.0
        i_won = dead.flip(1) & ~dead  # a simultaneous kill is a win for neither
        reward = (
            hits.float() * shaping["hit_reward"]
            - damage_taken * shaping["hit_penalty"]
            + i_won.float() * shaping["win_reward"]
        )

        steps = state["steps"] + 1
        any_dead = dead.any(dim=1)
        terminated = any_dead[:, None].expand(-1, 2)
        truncated = (~any_dead & (steps >= self.episode_len))[:, None].expand(-1, 2)

        new_state = {"pos": pos, "health": health, "steps": steps}
        info = {"active": torch.ones_like(dead)}
        return self._render_obs(new_state), new_state, reward.float(), terminated, truncated, info


def make_grid_duel_env(full_env_name: str, cfg=None, env_config=None, render_mode=None):
    if full_env_name == "grid_duel_small":
        # dense combat for short learning tests: long reach, several exchanges an episode
        return GridDuelEnv(size=12, episode_len=96, shoot_range=10, health=3.0)
    return GridDuelEnv()


def register_grid_duel() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env("grid_duel", make_grid_duel_env)
    register_env("grid_duel_small", make_grid_duel_env)
