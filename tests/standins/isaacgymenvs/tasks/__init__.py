"""The stand-in's tasks: one batched torch simulation behind every IsaacGymEnvs task name.

`StandInVecTask` has the interface of IGE's `VecTask` that the integration uses: the constructor's
keywords, `num_envs`, `observation_space`, `state_space` and `action_space` (objects with a
`shape`), `device` (the rl device), `reset()` -> obs dict, and `step(actions)` -> (obs dict,
rewards, resets, extras), all tensors on the sim's device, as IGE keeps its buffers on the card.
The obs dict holds `obs` [N, numObservations] and, where the task has states, `states`
[N, numStates]; `extras["time_outs"]` marks the envs whose episode ran out of time, and `resets`
includes them, as in IGE.

The dynamics are the stand-in's own: x' = 0.9 tanh(x A + a B) + noise, with a seeded random A and B
and Gaussian noise from a torch generator on the sim's device; reward 1 - mean(x^2) over the first
numActions state dims - 0.01 mean(a^2); an env terminates where |x_0| > 0.97 and times out at
episodeLength - 1 steps. As in IGE's tasks, an env that ended is reset at the start of the next step,
so the step that ends it returns its last observation. Episode clocks start staggered (a seeded offset
in [0, episodeLength)), so time-outs come within a few steps of a run's start.

Widths and default env counts are in `cfg/task/*.yaml`. Ant (4096 envs, 60 observations, 8 actions,
1000 steps), Humanoid (4096, 108, 21), Cartpole (512, 4, 1, 500 steps), AllegroHand (16384, 88, 16,
600 steps) and ShadowHand (16384, 211, 20) follow IGE's defaults, which IGE sets in its task classes
and yaml files (IGE's sources are not in this repository); the rest (Anymal, AnymalTerrain,
BallBalance, and AllegroHandLSTM's 50 observations and 88 states under the task name AllegroHand) are
the stand-in's own values.
"""

import torch


class _Space:
    def __init__(self, shape):
        self.shape = tuple(shape)


class StandInVecTask:
    def __init__(self, cfg, rl_device, sim_device, graphics_device_id, headless, virtual_screen_capture=False, force_render=False):
        env = cfg["env"]
        self.cfg = cfg
        self.num_envs = int(env["numEnvs"])
        self.num_obs, self.num_states, self.num_actions = int(env["numObservations"]), int(env.get("numStates", 0)), int(env["numActions"])
        self.max_episode_length = int(env["episodeLength"])
        self.clip_obs, self.clip_actions = float(env["clipObservations"]), float(env["clipActions"])
        self.device, self.sim_device = rl_device, sim_device
        self.headless = headless
        self.observation_space = _Space((self.num_obs,))
        self.state_space = _Space((self.num_states,))
        self.action_space = _Space((self.num_actions,))
        dim = max(self.num_obs, self.num_states, self.num_actions)
        self.gen = torch.Generator(device=sim_device).manual_seed(int(cfg.get("seed", 42)))
        self.a_map = torch.randn(dim, dim, generator=self.gen, device=sim_device) / dim ** 0.5
        self.b_map = torch.randn(self.num_actions, dim, generator=self.gen, device=sim_device) * 0.5
        self.x = torch.zeros(self.num_envs, dim, device=sim_device)
        self.progress_buf = torch.randint(0, self.max_episode_length, (self.num_envs,), generator=self.gen, device=sim_device)
        self.reset_buf = torch.ones(self.num_envs, dtype=torch.long, device=sim_device)
        self.timeout_buf = torch.zeros(self.num_envs, dtype=torch.long, device=sim_device)
        self.rew_buf = torch.zeros(self.num_envs, device=sim_device)
        self.extras = {}

    def _reset_idx(self, env_ids, staggered=False):
        self.x[env_ids] = 0.3 * torch.randn(len(env_ids), self.x.shape[1], generator=self.gen, device=self.sim_device)
        if not staggered:
            self.progress_buf[env_ids] = 0
        self.reset_buf[env_ids] = 0

    def _obs_dict(self):
        obs = {"obs": torch.clamp(self.x[:, : self.num_obs], -self.clip_obs, self.clip_obs).to(self.device)}
        if self.num_states > 0:
            obs["states"] = self.x[:, : self.num_states].to(self.device)
        return obs

    def reset(self):
        self._reset_idx(torch.arange(self.num_envs, device=self.sim_device), staggered=True)
        return self._obs_dict()

    def step(self, actions):
        actions = torch.clamp(actions.to(self.sim_device), -self.clip_actions, self.clip_actions)
        ended = self.reset_buf.nonzero(as_tuple=False).flatten()
        if len(ended) > 0:
            self._reset_idx(ended)
        noise = 0.05 * torch.randn(self.x.shape, generator=self.gen, device=self.sim_device)
        self.x = 0.9 * torch.tanh(self.x @ self.a_map + actions @ self.b_map) + noise
        self.progress_buf += 1
        self.rew_buf = 1.0 - (self.x[:, : self.num_actions] ** 2).mean(1) - 0.01 * (actions**2).mean(1)
        self.timeout_buf = (self.progress_buf >= self.max_episode_length - 1).long()
        self.reset_buf = ((self.x[:, 0].abs() > 0.97) | (self.timeout_buf > 0)).long()
        self.extras["time_outs"] = self.timeout_buf.to(self.device)
        return self._obs_dict(), self.rew_buf.to(self.device), self.reset_buf.to(self.device), self.extras


isaacgym_task_map = {name: StandInVecTask for name in ("Ant", "Anymal", "AnymalTerrain", "BallBalance", "Cartpole", "ShadowHand",
                                                       "Humanoid", "AllegroHand")}
