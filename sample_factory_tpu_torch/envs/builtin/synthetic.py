"""Synthetic test environments for end-to-end learning tests, batched over N envs.

Counterpart of `sample_factory_tpu/envs/builtin/synthetic.py` (modelled on the
reference's test env, `sf_examples/train_custom_env_custom_model.py:30-75`:
random observations, reward = action index x coefficient, fixed episode
length): the harness that exercises runner, sampler, learner and checkpoints
at once. A continuous twin covers Gaussian policies, a tuple twin the hybrid
action space, a masked twin the `action_mask` path. Every observation is a
draw (`reset_draws`/`step_draws`), so a test can feed the JAX env's.
The JAX package's multi-agent matching game is a host env and comes with the
host path (ROADMAP A11); the multi-agent device env is `grid_duel.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv
from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.spaces import Box, Discrete, TupleSpec, make_dict_spec

ENV_NAMES = (
    "synthetic_discrete", "synthetic_vector_discrete", "synthetic_continuous", "synthetic_tuple", "synthetic_masked",
    "grid_battle", "grid_battle_small",
)


class _RandomObsEnv(DeviceEnv):
    """Uniform random observations, episodes of a fixed length that end by termination.
    Subclasses set the spaces and `_reward(actions, shaping)`."""

    obs_shape = (4,)
    episode_len = 16

    def _obs_draws(self, num_envs, generator, device):
        return {"obs": torch.rand((num_envs,) + tuple(self.obs_shape), generator=generator, device=device)}

    def reset_draws(self, num_envs, generator, device):
        return self._obs_draws(num_envs, generator, device)

    def step_draws(self, num_envs, generator, device):
        return self._obs_draws(num_envs, generator, device)

    def _obs(self, draws, device):
        return {"obs": draws["obs"].to(device=device, dtype=torch.float32)}

    def _reward(self, actions, shaping):
        raise NotImplementedError

    def _reset(self, num_envs, device, draws):
        return self._obs(draws, device), {"steps": torch.zeros((num_envs,), dtype=torch.int32, device=device)}

    def _step(self, state, actions, draws, shaping):
        steps = state["steps"] + 1
        terminated = steps >= self.episode_len
        truncated = torch.zeros_like(terminated)
        reward = self._reward(actions, shaping).float()
        return self._obs(draws, actions.device), {"steps": steps}, reward, terminated, truncated, {}


class SyntheticDiscreteEnv(_RandomObsEnv):
    """Pick the biggest action index -> biggest reward. Pixel observations (HWC)."""

    def __init__(self, num_actions: int = 10, episode_len: int = 16, res: int = 10, action_rew_coeff: float = 0.01):
        self.num_actions = num_actions
        self.episode_len = episode_len
        self.res = res
        self.obs_shape = (res, res, 1)
        self.reward_shaping = {"action_rew_coeff": action_rew_coeff}
        self.obs_space = make_dict_spec({"obs": Box(self.obs_shape, 0.0, 1.0)})
        self.action_space = Discrete(num_actions)

    def _reward(self, actions, shaping):
        a = actions[..., 0] if actions.dim() > 1 else actions
        return a.float() * shaping["action_rew_coeff"]


class SyntheticVectorDiscreteEnv(SyntheticDiscreteEnv):
    """Same objective, flat vector observations (fast; exercises the MLP encoder)."""

    def __init__(self, num_actions: int = 10, episode_len: int = 16, dim: int = 8, action_rew_coeff: float = 0.01):
        super().__init__(num_actions, episode_len, res=1, action_rew_coeff=action_rew_coeff)
        self.dim = dim
        self.obs_shape = (dim,)
        self.obs_space = make_dict_spec({"obs": Box((dim,), 0.0, 1.0)})


class SyntheticContinuousEnv(_RandomObsEnv):
    """Reward = -||action - target||^2; tests Gaussian policies end to end."""

    def __init__(self, dim: int = 2, episode_len: int = 16, target: float = 0.4):
        self.dim = dim
        self.episode_len = episode_len
        self.target = target
        self.obs_space = make_dict_spec({"obs": Box((4,), 0.0, 1.0)})
        self.action_space = Box((dim,), -1.0, 1.0)

    def _reward(self, actions, shaping):
        return -(actions - self.target).square().sum(dim=-1)


class SyntheticTupleActionEnv(_RandomObsEnv):
    """Hybrid action space (Discrete + Box): exercises TupleDistribution end to end.
    Rewards discrete action 2 and continuous actions near 0.5."""

    def __init__(self, episode_len: int = 16):
        self.episode_len = episode_len
        self.obs_space = make_dict_spec({"obs": Box((4,), 0.0, 1.0)})
        self.action_space = TupleSpec((Discrete(3), Box((2,), -1.0, 1.0)))

    def _reward(self, actions, shaping):
        return 0.1 * actions[..., 0] - (actions[..., 1:] - 0.5).square().sum(dim=-1)


class SyntheticMaskedEnv(SyntheticVectorDiscreteEnv):
    """Discrete env with action masking: the top action is masked out half the time, so
    the best masked policy picks the second-best then. Exercises the action_mask path."""

    def __init__(self, num_actions: int = 6, episode_len: int = 16, dim: int = 8):
        super().__init__(num_actions=num_actions, episode_len=episode_len, dim=dim)
        self.obs_space = make_dict_spec({"obs": Box((dim,), 0.0, 1.0), "action_mask": Box((num_actions,), 0.0, 1.0)})

    def _obs_draws(self, num_envs, generator, device):
        draws = super()._obs_draws(num_envs, generator, device)
        draws["top_masked"] = torch.rand((num_envs,), generator=generator, device=device) < 0.5
        return draws

    def _obs(self, draws, device):
        obs = super()._obs(draws, device)
        mask = torch.ones((obs["obs"].shape[0], self.num_actions), device=device)
        mask[:, -1] = 1.0 - draws["top_masked"].to(device=device, dtype=torch.float32)
        obs["action_mask"] = mask
        return obs


def make_synthetic_env(full_env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    num_actions = getattr(cfg, "custom_env_num_actions", 10) if cfg is not None else 10
    episode_len = getattr(cfg, "custom_env_episode_len", 16) if cfg is not None else 16
    if full_env_name == "synthetic_discrete":
        return SyntheticDiscreteEnv(num_actions=num_actions, episode_len=episode_len)
    if full_env_name == "synthetic_vector_discrete":
        return SyntheticVectorDiscreteEnv(num_actions=num_actions, episode_len=episode_len)
    if full_env_name == "synthetic_continuous":
        return SyntheticContinuousEnv(episode_len=episode_len)
    if full_env_name == "synthetic_tuple":
        return SyntheticTupleActionEnv(episode_len=episode_len)
    if full_env_name == "synthetic_masked":
        return SyntheticMaskedEnv(episode_len=episode_len)
    if full_env_name == "grid_battle":
        return GridBattleEnv()
    if full_env_name == "grid_battle_small":
        return GridBattleEnv(size=12, num_enemies=4, episode_len=128, shoot_range=5)
    raise ValueError(f"Unknown synthetic env {full_env_name}")
