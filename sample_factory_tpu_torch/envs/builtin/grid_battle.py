"""GridBattle: an on-device pixel combat env, batched over N envs.

Counterpart of `sample_factory_tpu/envs/builtin/grid_battle.py`: the agent
moves on a grid, shoots enemies that chase it and loses health on contact;
pixel observations (HWC), discrete actions, termination on death and
truncation at the time limit. The same rules, written for [N, ...] tensors
instead of one instance under vmap. Two details keep it step-equal to the
JAX env: enemies on one cell add up in the image before the clip (:54,58), and
the shot takes the first nearest enemy, as `jnp.argmin` and `torch.argmin` do.
"""

from __future__ import annotations

import torch

from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, make_dict_spec

# actions: 0..3 move NSEW, 4 shoot, 5 idle
MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0), (0, 0))
NO_TARGET = 10**6


class GridBattleEnv(DeviceEnv):
    def __init__(self, size: int = 24, num_enemies: int = 8, episode_len: int = 256, shoot_range: int = 6):
        self.size = size
        self.num_enemies = num_enemies
        self.episode_len = episode_len
        self.shoot_range = shoot_range
        self.obs_space = make_dict_spec({"obs": Box((size, size, 3), 0.0, 1.0)})
        self.action_space = Discrete(6)
        self.reward_shaping = {"kill_reward": 1.0, "hit_penalty": 0.2}
        self.supports_dynamic_shaping = True

    # ------------------------------------------------------------------ draws

    def reset_draws(self, num_envs, generator, device):
        shape = (num_envs, self.num_enemies, 2)
        return {"enemies": torch.randint(0, self.size, shape, generator=generator, device=device)}

    def step_draws(self, num_envs, generator, device):
        E = self.num_enemies
        return {
            "stall": torch.rand((num_envs, E), generator=generator, device=device) < 0.5,
            "spawn": torch.randint(0, self.size, (num_envs, E, 2), generator=generator, device=device),
            "respawn": torch.rand((num_envs, E), generator=generator, device=device) < 0.05,
        }

    # ------------------------------------------------------------------ state

    def _render_obs(self, state):
        agent, enemies = state["agent"], state["enemies"]
        n, S, device = agent.shape[0], self.size, agent.device
        img = torch.zeros((n, S, S, 3), device=device)
        rows = torch.arange(n, device=device)
        img[rows, agent[:, 0], agent[:, 1], 0] = 1.0
        ex, ey = enemies[..., 0], enemies[..., 1]
        env_idx = rows[:, None].expand_as(ex)
        img.index_put_((env_idx, ex, ey, torch.ones_like(ex)), state["alive"].float(), accumulate=True)
        # health bar along the top row of channel 2
        health_cols = torch.arange(S, device=device)[None, :] < (state["health"][:, None] * S / 5.0)
        img[:, 0, :, 2] = health_cols.float()
        return {"obs": img.clamp_(0.0, 1.0)}

    def _reset(self, num_envs, device, draws):
        state = {
            "agent": torch.full((num_envs, 2), self.size // 2, dtype=torch.int64, device=device),
            "enemies": draws["enemies"].to(device=device, dtype=torch.int64),
            "alive": torch.ones((num_envs, self.num_enemies), dtype=torch.bool, device=device),
            "health": torch.full((num_envs,), 5.0, device=device),
            "steps": torch.zeros((num_envs,), dtype=torch.int64, device=device),
        }
        return self._render_obs(state), state

    def _step(self, state, actions, draws, shaping):
        a = (actions[..., 0] if actions.dim() > 1 else actions).long()
        device = a.device
        moves = torch.tensor(MOVES, dtype=torch.int64, device=device)
        agent = (state["agent"] + moves[a]).clamp(0, self.size - 1)

        # enemies chase: step one cell toward the agent (with a random stall)
        delta = torch.sign(agent[:, None, :] - state["enemies"])
        moving = (~draws["stall"].to(device)).long()[..., None]
        enemies = (state["enemies"] + delta * moving).clamp(0, self.size - 1)

        # shooting: kill the nearest alive enemy in the same row or column within range
        diff = enemies - agent[:, None, :]
        same_row = (diff[..., 0] == 0) & (diff[..., 1].abs() <= self.shoot_range)
        same_col = (diff[..., 1] == 0) & (diff[..., 0].abs() <= self.shoot_range)
        in_sights = (same_row | same_col) & state["alive"]
        dist = diff.abs().sum(-1)
        target_score = torch.where(in_sights, dist, torch.full_like(dist, NO_TARGET))
        target = target_score.argmin(-1)
        best = target_score.gather(-1, target[:, None])[:, 0]
        shot_hits = (a == 4) & (best < NO_TARGET)
        enemy_idx = torch.arange(self.num_enemies, device=device)
        alive = state["alive"] & ~(shot_hits[:, None] & (enemy_idx[None, :] == target[:, None]))
        kills = state["alive"].sum(-1) - alive.sum(-1)

        # enemy contact damages the agent
        contact = (((enemies - agent[:, None, :]).abs().sum(-1) <= 1) & alive).sum(-1).float()
        health = state["health"] - 0.5 * contact

        # dead enemies respawn at a random cell (endless battle)
        respawn = draws["respawn"].to(device) & ~alive
        enemies = torch.where(respawn[..., None], draws["spawn"].to(device=device, dtype=torch.int64), enemies)
        alive = alive | respawn

        reward = kills.float() * shaping["kill_reward"] - shaping["hit_penalty"] * contact
        steps = state["steps"] + 1
        terminated = health <= 0.0
        truncated = steps >= self.episode_len

        new_state = {"agent": agent, "enemies": enemies, "alive": alive, "health": health, "steps": steps}
        return self._render_obs(new_state), new_state, reward, terminated, truncated, {}
