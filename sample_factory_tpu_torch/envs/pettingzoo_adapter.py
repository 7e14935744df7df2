"""PettingZoo integration: ParallelEnv -> the framework's multi-agent host-env
convention.

Copy of `sample_factory_tpu/envs/pettingzoo_adapter.py` (reference `sf_examples/pettingzoo_envs.py`: PettingZoo as the
multi-agent env source). Supports simultaneous-move games natively; turn-based
(AEC) games can be converted with pettingzoo.utils.aec_to_parallel when the
game permits. Homogeneous agent spaces are assumed (the framework's batched
multi-agent path, like the reference's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    gym = None


class PettingZooParallelAdapter:
    """Wrap a pettingzoo ParallelEnv into the list-based multi-agent API
    (num_agents, is_multiagent, step(list)->lists, is_active infos)."""

    def __init__(self, parallel_env):
        self.env = parallel_env
        self.agents = list(parallel_env.possible_agents)
        self.num_agents = len(self.agents)
        self.is_multiagent = True

        obs_space = parallel_env.observation_space(self.agents[0])
        self._discrete_obs: Optional[int] = None
        if isinstance(obs_space, gym.spaces.Discrete):
            # one-hot encode discrete observations for the MLP encoder
            self._discrete_obs = int(obs_space.n)
            obs_space = gym.spaces.Box(0.0, 1.0, (self._discrete_obs,), dtype=np.float32)
        elif isinstance(obs_space, gym.spaces.Dict) and "observation" in obs_space.spaces:
            # classic-game convention {observation, action_mask}
            obs_space = gym.spaces.Dict(
                {"obs": obs_space.spaces["observation"], "action_mask": obs_space.spaces["action_mask"]}
            )
        self.observation_space = obs_space
        self.action_space = parallel_env.action_space(self.agents[0])

    def _convert_obs(self, obs):
        if self._discrete_obs is not None:
            onehot = np.zeros(self._discrete_obs, np.float32)
            onehot[int(obs)] = 1.0
            return onehot
        if isinstance(obs, dict) and "observation" in obs:
            return {"obs": np.asarray(obs["observation"], np.float32), "action_mask": np.asarray(obs["action_mask"], np.float32)}
        return np.asarray(obs, np.float32)

    def _obs_list(self, obs_dict):
        zero = None
        out = []
        for a in self.agents:
            if a in obs_dict:
                out.append(self._convert_obs(obs_dict[a]))
            else:
                if zero is None:
                    template = next(iter(obs_dict.values())) if obs_dict else 0
                    zero = self._convert_obs(template)
                    zero = {k: np.zeros_like(v) for k, v in zero.items()} if isinstance(zero, dict) else np.zeros_like(zero)
                out.append(zero)
        return out

    def reset(self, seed=None, **kwargs):
        obs, infos = self.env.reset(seed=seed)
        info_list = [dict(infos.get(a, {})) for a in self.agents]
        return self._obs_list(obs), info_list

    def step(self, actions):
        live = set(self.env.agents)
        action_dict = {a: int(act) if np.isscalar(act) or getattr(act, "ndim", 1) == 0 else act
                       for a, act in zip(self.agents, actions) if a in live}
        obs, rewards, terms, truncs, infos = self.env.step(action_dict)

        obs_list = self._obs_list(obs)
        reward_list = [float(rewards.get(a, 0.0)) for a in self.agents]
        term_list = [bool(terms.get(a, True)) for a in self.agents]
        trunc_list = [bool(truncs.get(a, False)) for a in self.agents]
        info_list = []
        for a in self.agents:
            info = dict(infos.get(a, {}))
            info["is_active"] = a in live
            info_list.append(info)
        return obs_list, reward_list, term_list, trunc_list, info_list

    def close(self):
        self.env.close()


def make_pettingzoo_env(module_path: str, parallel: bool = True, **env_kwargs):
    """Build an adapter from a pettingzoo module path, e.g.
    'pettingzoo.classic.rps_v2'."""
    import importlib

    module = importlib.import_module(module_path)
    if parallel and hasattr(module, "parallel_env"):
        env = module.parallel_env(**env_kwargs)
    else:
        aec_env = module.env(**env_kwargs)
        if aec_env.metadata.get("is_parallelizable", False):
            from pettingzoo.utils import aec_to_parallel

            env = aec_to_parallel(aec_env)
        else:
            # turn-based classics (tictactoe, chess, ...): reference
            # train_pettingzoo_env.py uses turn_based_aec_to_parallel
            from pettingzoo.utils import turn_based_aec_to_parallel

            env = turn_based_aec_to_parallel(aec_env)
    return PettingZooParallelAdapter(env)
