"""Agent <-> policy assignment for multi-policy training.

Counterpart of `sample_factory_tpu/algo/agent_policy_mapping.py` (reference
`sample_factory/algo/utils/agent_policy_mapping.py:39-59`): deterministic
`env_idx % num_policies` in sync mode (equal experience per policy and
iteration), random draws in async mode, optional mixing of policies within one
env (self-play). Host-side numpy; slots are env-major, `env_idx * A + agent_idx`.
"""

from __future__ import annotations

import numpy as np


class AgentPolicyMapping:
    RESAMPLE_EVERY_EPISODES = 10

    def __init__(self, cfg, env_info):
        self.num_agents = env_info.num_agents
        self.num_policies = cfg.num_policies
        self.mix_policies_in_one_env = bool(getattr(cfg, "pbt_mix_policies_in_one_env", False))
        self.sync_mode = not cfg.async_rl
        self.rng = np.random.default_rng(cfg.seed)
        self._episodes_seen = 0

    def initial_slot_policies(self, num_slots: int) -> np.ndarray:
        """Policy index per agent slot."""
        A, P = self.num_agents, self.num_policies
        num_envs = num_slots // A
        if self.mix_policies_in_one_env:
            if self.sync_mode:
                # deterministic mixing: slot s gets policy s % P, so every policy gets the
                # same share of experience and the policies meet each other within envs
                return (np.arange(num_slots) % P).astype(np.int32)
            # async mixing: an independent random policy per agent slot
            return self.rng.integers(0, P, size=num_slots).astype(np.int32)
        # all agents of env e get policy e % P
        per_env = np.arange(num_envs) % P
        return np.repeat(per_env, A).astype(np.int32)

    def maybe_resample(self, slot_policies: np.ndarray, episodes_completed: int) -> np.ndarray:
        """Async mode: draw the assignment anew every RESAMPLE_EVERY_EPISODES episodes an env
        (reference :47-59). The host multi-policy runner calls it after each iteration."""
        if self.sync_mode:
            return slot_policies
        self._episodes_seen += episodes_completed
        if self._episodes_seen >= self.RESAMPLE_EVERY_EPISODES * max(1, len(slot_policies) // self.num_agents):
            self._episodes_seen = 0
            A, P = self.num_agents, self.num_policies
            num_envs = len(slot_policies) // A
            if self.mix_policies_in_one_env:
                return self.rng.integers(0, P, size=len(slot_policies)).astype(np.int32)
            per_env = self.rng.integers(0, P, size=num_envs)
            return np.repeat(per_env, A).astype(np.int32)
        return slot_policies
