"""Multi-policy self-play on host (gymnasium) envs.

Counterpart of `sample_factory_tpu/runner/host_multi_policy_runner.py`, without
its multi-host branches. It joins the host sampler's mixed-policy collection
(each policy's forward on its own agent slots, `algo/host_sampling.py`) with the
population of `MultiPolicyRunner` (a list of P train states, per-policy writers
and checkpoints) and PBT (`pbt/pbt.py`). Every policy trains on the whole shared
trajectory, masked to its own agents by the learner's valids: mid-episode policy
changes and inactive agents (`policy_id == -1`) are handled as in the reference
(non_batched_sampling.py:259-276, masking in learner.py:949-955).

Async mode (the default) keeps the JAX runner's schedule (:157-198): the rollout
runs a snapshot of each policy taken just before the last train call (the
parameters that call started from), with that version stamped on the trajectory.
Here a policy's snapshot is a second module, since the optimizer updates the
trained one in place. There is no learner-quanta overlap on this path, as in the
JAX package. After each iteration the async agent-to-policy mapping may be drawn
anew (`AgentPolicyMapping.maybe_resample`), and PBT-mutated reward shaping is
pushed to the workers' envs by slot mask.

Episode attribution (a deviation from the JAX runner, which gives every policy
the same share of the aggregate window, :268-270): a completed episode is
credited to the policy that drove its agent slot during that rollout, so that
PBT compares what each policy earned.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import numpy as np
import torch

from sample_factory_tpu_torch.algo.agent_policy_mapping import AgentPolicyMapping
from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.pbt.pbt import PopulationBasedTraining
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.runner.multi_policy_runner import MultiPolicyRunner
from sample_factory_tpu_torch.runner.stats import SummaryWriter
from sample_factory_tpu_torch.utils.utils import log


class HostMultiPolicyRunner(MultiPolicyRunner):
    def __init__(self, cfg, register_fn: Optional[Callable] = None):
        super().__init__(cfg)
        self.register_fn = register_fn
        self.sampler: Optional[HostVectorSampler] = None
        self.mapping: Optional[AgentPolicyMapping] = None
        self.slot_policies: Optional[np.ndarray] = None  # [K, split_size]
        self.behavior_models = None  # async: one snapshot module a policy
        self.behavior_obs_rms = None
        self.behavior_versions = None
        self.mapping_resamples = 0  # times maybe_resample drew a new mapping

    def _init_env(self) -> None:
        self.env_info = obtain_env_info(self.cfg, register_fn=self.register_fn)
        assert not self.env_info.is_device_env

    def init(self) -> None:
        cfg, P = self.cfg, self.P
        self._init_experiment()
        device = self.device
        self.writers = [SummaryWriter(cfg, p) for p in range(P)]
        self.writer = self.writers[0]

        # one stream of initial parameters, as in MultiPolicyRunner
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.train_state = []
        for _ in range(P):
            model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, init_gen).to(device)
            self.train_state.append(init_train_state(cfg, self.env_info, model, device))
        self.model = self.train_state[0].model
        self.train_generators = [torch.Generator(device).manual_seed(cfg.seed + 2 + 2 * p) for p in range(P)]

        self.sampler = HostVectorSampler(cfg, self.env_info, device, register_fn=self.register_fn)
        cfg.num_envs = self.sampler.num_envs
        try:
            self.sampler.start()
        except BaseException:
            self.sampler.close()
            raise

        self.mapping = AgentPolicyMapping(cfg, self.env_info)
        if self.sampler.num_envs % P != 0:
            # sync-mode slot % P mixing only yields equal per-policy experience when slots divide evenly
            log.warning("num agent-slots (%d) is not divisible by num_policies (%d): per-policy experience "
                        "will be imbalanced by up to 1 slot", self.sampler.num_envs, P)
        self.slot_policies = self.mapping.initial_slot_policies(self.sampler.num_envs).reshape(
            self.sampler.K, self.sampler.split_size)

        for p, ts in enumerate(self.train_state):
            restored = load_checkpoint(cfg, p, ts)
            if restored is not None:
                steps_p, self.best_performance_per_policy[p] = restored
                self.env_steps = max(self.env_steps, steps_p)

        self._train_fn = make_train_fn(cfg, self.env_info, 0)  # the policy index goes in with each call
        if cfg.async_rl:
            self.behavior_models = [copy.deepcopy(ts.model).requires_grad_(False) for ts in self.train_state]
            self._refresh_behavior()

        if cfg.with_pbt:
            self.pbt = PopulationBasedTraining(cfg, P, default_reward_shaping=self.env_info.reward_shaping_scheme)
        log.info("HostMultiPolicyRunner: %d policies, %d agent-slots (%d agents/env), mixing=%s, PBT=%s, transport=%s, device %s",
                 P, self.sampler.num_envs, self.env_info.num_agents, self.mapping.mix_policies_in_one_env,
                 bool(cfg.with_pbt), self.sampler.transport, device)
        for obs in self.observers:
            obs.on_init(self)

    # ------------------------------------------------------------- iteration

    def _refresh_behavior(self) -> None:
        """Every policy's live parameters, normalizer and version become its snapshot."""
        with torch.no_grad():
            for behavior, ts in zip(self.behavior_models, self.train_state):
                torch._foreach_copy_(list(behavior.parameters()), list(ts.model.parameters()))
        self.behavior_obs_rms = [ts.obs_rms for ts in self.train_state]
        self.behavior_versions = [ts.train_step for ts in self.train_state]

    def _train_iteration(self):
        states = self.train_state
        if self.cfg.async_rl:
            models, obs_rms, versions = self.behavior_models, self.behavior_obs_rms, self.behavior_versions
        else:
            models, obs_rms, versions = [ts.model for ts in states], [ts.obs_rms for ts in states], [ts.train_step for ts in states]
        if obs_rms[0] is None:
            obs_rms = None
        with self.timing.add_time("rollout"):
            traj, ep_stats = self.sampler.collect_rollout(models, obs_rms, versions, slot_policies=self.slot_policies)
        if self.cfg.async_rl:
            # the next rollout's behaviour: what this train call starts from
            self._refresh_behavior()
        with self.timing.add_time("train"):
            stats = [self._train_fn(ts, traj, self.train_generators[p], pid=p) for p, ts in enumerate(states)]
        return stats, ep_stats

    def _transitions_per_iteration(self) -> int:
        return self.sampler.num_envs * self.cfg.rollout

    def _process_stats(self, stats, ep_stats) -> None:
        """Credit each completed episode to the policy that drove its slot in this rollout."""
        self.fps_tracker.add(time.time(), self.env_steps)
        flat = self.slot_policies.reshape(-1)
        sums = np.zeros((self.P, 3))
        for (ret, length), slot in zip(ep_stats["episodes"], ep_stats["slots"]):
            sums[flat[slot]] += (1.0, ret, length)
        for p in range(self.P):
            self.episode_stats_per_policy[p].add_rollout_stats(*sums[p])
        self._episodes_last_rollout = int(ep_stats["count"])
        # an episode's custom stats go to policy 0, as in the JAX runner (:271-276)
        self._dispatch_extra_stats(ep_stats.get("extra_stats", ()), 0)
        self._last_stats = stats

    def _after_iteration(self) -> None:
        # async mode: periodically re-randomize the agent->policy mapping
        flat = self.slot_policies.reshape(-1)
        new_map = self.mapping.maybe_resample(flat, self._episodes_last_rollout)
        if new_map is not flat:
            self.mapping_resamples += 1
        self.slot_policies = np.asarray(new_map).reshape(self.sampler.K, self.sampler.split_size)
        super()._after_iteration()

    def _apply_shaping_updates(self) -> None:
        """Push PBT's mutated reward shaping to the envs of the policy's own agent slots."""
        for policy_id, shaping in self.pbt.pending_shaping_updates:
            self.sampler.set_reward_shaping(shaping, self.slot_policies == policy_id)
        self.pbt.pending_shaping_updates.clear()

    def _release_resources(self) -> None:
        if self.sampler is not None:
            self.sampler.close()
