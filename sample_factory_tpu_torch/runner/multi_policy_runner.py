"""Multi-policy (population) runner: P policies trained side by side on one device.

Counterpart of `sample_factory_tpu/runner/multi_policy_runner.py` (the
reference runs one learner process per policy, `algo/learning/learner_worker.py:44-45`,
with the agent->policy mapping of `algo/utils/agent_policy_mapping.py:39-59`).
The JAX package stacks the policies on a leading axis and trains the population
as one vmapped program; here the population is a list of P train states, each
with its own module and optimizer, and an iteration is a Python loop over them:

- unmixed (single-agent envs, :151-160): the envs are split into P contiguous
  blocks of `num_envs // P`; each policy has its own sampler state and
  generators, and does a rollout on its block and then a train call on it;
- mixed (`env.num_agents > 1`, :132-150, P = 1 included): the agents of all envs
  are policy slots, one shared rollout drives every slot by its own policy
  (`algo/sampling.py:make_mixed_rollout_fn`), and every policy then trains on the
  whole trajectory masked to its own slots by the learner's `policy_id` valids.

As in the JAX runner there is one schedule whatever `--async_rl` says (rollout
with the live parameters at version `train_step`, then train); the flag only
changes the initial slot mapping. PBT's exploit and explore steps run on the
host between iterations (`pbt/pbt.py`). `train_state` is the list of P train
states, `sampler_state` a list of P (unmixed) or one (mixed); the stats handed
to observers and `host_stats` are lists of P dicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from sample_factory_tpu_torch.algo.agent_policy_mapping import AgentPolicyMapping
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.sampling import (
    init_mixed_sampler_state,
    init_sampler_state,
    make_mixed_rollout_fn,
    make_rollout_fn,
)
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.pbt.pbt import PopulationBasedTraining
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint, save_checkpoint
from sample_factory_tpu_torch.runner.runner import Runner
from sample_factory_tpu_torch.runner.stats import EpisodeStats, SummaryWriter
from sample_factory_tpu_torch.utils.utils import done_filename, log

EPISODIC_KEYS = ("count", "return_sum", "len_sum")


class MultiPolicyRunner(Runner):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.P = cfg.num_policies
        self.episode_stats_per_policy: List[EpisodeStats] = [EpisodeStats(cfg.stats_avg) for _ in range(self.P)]
        self.writers: List[Optional[SummaryWriter]] = [None] * self.P
        self.pbt: Optional[PopulationBasedTraining] = None
        self.best_performance_per_policy = [-1e9] * self.P
        self.train_generators: List[torch.Generator] = []
        self._slot_policies = None

    def init(self) -> None:
        cfg, P = self.cfg, self.P
        self._init_experiment()
        env, device = self.env, self.device
        self.writers = [SummaryWriter(cfg, p) for p in range(P)]
        self.writer = self.writers[0]

        # multi-agent envs train with within-env policy mixing: the agents of one env are
        # driven by different policies of the population (self-play)
        self.A = self.env_info.num_agents
        self.mixed = self.A > 1
        if self.mixed:
            self.num_slots = cfg.num_envs * self.A
            if self.num_slots % P:
                raise ValueError(f"num_envs*num_agents ({self.num_slots}) must divide by num_policies ({P})")
        else:
            if cfg.num_envs % P:
                raise ValueError(f"num_envs ({cfg.num_envs}) must divide by num_policies ({P})")
            self.envs_per_policy = cfg.num_envs // P

        # one stream of initial parameters: policy 0 gets the single-policy runner's, the others what follows
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.train_state = []
        for _ in range(P):
            model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, init_gen).to(device)
            self.train_state.append(init_train_state(cfg, self.env_info, model, device))
        self.model = self.train_state[0].model

        def generator(offset: int) -> torch.Generator:
            return torch.Generator(device).manual_seed(cfg.seed + offset)

        self.train_generators = [generator(2 + 2 * p) for p in range(P)]
        if self.mixed:
            self.sampler_state = init_mixed_sampler_state(cfg, env, cfg.num_envs, P, device, generator(1))
            self._slot_policies = AgentPolicyMapping(cfg, self.env_info).initial_slot_policies(self.num_slots)
            self._rollout_fn = make_mixed_rollout_fn(cfg, env, self.env_info, P)
        else:
            self.sampler_state = [
                init_sampler_state(cfg, env, self.envs_per_policy, device, generator(1 + 2 * p)) for p in range(P)
            ]
            self._rollout_fn = make_rollout_fn(cfg, env, self.env_info)
        self._train_fn = make_train_fn(cfg, self.env_info, 0)  # the policy index goes in with each call

        # per-policy checkpoint restore
        for p, ts in enumerate(self.train_state):
            restored = load_checkpoint(cfg, p, ts)
            if restored is not None:
                steps_p, self.best_performance_per_policy[p] = restored
                self.env_steps = max(self.env_steps, steps_p)

        if cfg.with_pbt:
            self.pbt = PopulationBasedTraining(cfg, P, default_reward_shaping=self.env_info.reward_shaping_scheme)
        if self.mixed:
            log.info("MultiPolicyRunner: %d policies mixed over %d envs x %d agents (self-play), PBT=%s, device %s",
                     P, cfg.num_envs, self.A, bool(cfg.with_pbt), device)
        else:
            log.info("MultiPolicyRunner: %d policies x %d envs, PBT=%s, device %s",
                     P, self.envs_per_policy, bool(cfg.with_pbt), device)
        for obs in self.observers:
            obs.on_init(self)

    # ------------------------------------------------------------- iteration

    def _train_iteration(self):
        """-> (stats: list of P dicts, episodic sums: {key: [P] tensor})."""
        states = self.train_state
        if self.mixed:
            # one shared rollout with every slot driven by its own policy, then every policy
            # trains on the shared trajectory masked to its own slots
            obs_rms = None if states[0].obs_rms is None else [ts.obs_rms for ts in states]
            self.sampler_state, traj, ep_stats = self._rollout_fn(
                [ts.model for ts in states], obs_rms, self.sampler_state, self._slot_policies,
                [ts.train_step for ts in states],
            )
            stats = [self._train_fn(ts, traj, self.train_generators[p], pid=p) for p, ts in enumerate(states)]
            return stats, ep_stats
        stats, episodic = [], []
        for p, ts in enumerate(states):
            self.sampler_state[p], traj, ep_stats = self._rollout_fn(ts.model, ts.obs_rms, self.sampler_state[p], ts.train_step, p)
            stats.append(self._train_fn(ts, traj, self.train_generators[p], pid=p))
            episodic.append(ep_stats)
        return stats, {k: torch.stack([ep[k] for ep in episodic]) for k in EPISODIC_KEYS}

    def _transitions_per_iteration(self) -> int:
        return self.cfg.num_envs * self.env_info.num_agents * self.cfg.rollout

    def _after_iteration(self) -> None:
        if self.pbt is None:
            return
        per_policy_steps = [self.env_steps // self.P] * self.P
        if self.pbt.due(per_policy_steps):
            self.pbt.on_training_step(self.train_state, per_policy_steps, self._pbt_objectives())
            self._apply_shaping_updates()

    # ------------------------------------------------------------- internals

    def _apply_shaping_updates(self) -> None:
        """Write PBT's mutated reward-shaping coefficients where the rollout reads them: into
        the policy's own sampler state (unmixed) or its row of the [P] tensors (mixed)."""
        if not self.pbt.pending_shaping_updates:
            return
        mixed_or_first = self.sampler_state if self.mixed else self.sampler_state[0]
        if mixed_or_first.shaping is None:
            log.warning("PBT mutated reward shaping but env %s has no dynamic shaping support; ignored", self.cfg.env)
            self.pbt.pending_shaping_updates.clear()
            return
        for policy_id, new_values in self.pbt.pending_shaping_updates:
            if self.mixed:
                for k, row in self.sampler_state.shaping.items():
                    if k in new_values:
                        row[policy_id] = float(new_values[k])
            else:
                ss = self.sampler_state[policy_id]
                ss.shaping = {k: float(new_values.get(k, v)) for k, v in ss.shaping.items()}
        self.pbt.pending_shaping_updates.clear()

    def _pbt_objectives(self) -> List[Optional[float]]:
        """The stat named by --pbt_target_objective where an observer filled
        `policy_avg_stats` with it, else the windowed episode reward."""
        self._drain_ep_stats()
        custom = self.policy_avg_stats.get(self.cfg.pbt_target_objective)
        if custom is not None:
            return [float(sum(custom[p]) / len(custom[p])) if len(custom[p]) else None for p in range(self.P)]
        return [es.avg_reward for es in self.episode_stats_per_policy]

    def _drain_ep_stats(self) -> None:
        if not self._pending_ep:
            return
        pending, self._pending_ep = self._pending_ep, []
        # [iterations, keys, P] in one transfer
        host = torch.stack([torch.stack([ep[k].float() for k in EPISODIC_KEYS]) for ep in pending]).cpu().tolist()
        for count, return_sum, len_sum in host:
            for p in range(self.P):
                self.episode_stats_per_policy[p].add_rollout_stats(count[p], return_sum[p], len_sum[p])

    def host_stats(self, stats=None) -> List[Dict[str, float]]:
        """The last iteration's stats of every policy, fetched in one transfer."""
        stats = self._last_stats if stats is None else stats
        if not stats:
            return []
        keys = list(stats[0].keys())
        values = torch.stack([torch.stack([s[k].detach().float().reshape(()) for k in keys]) for s in stats]).cpu().tolist()
        return [dict(zip(keys, row)) for row in values]

    def _report(self, stats) -> None:
        self._drain_ep_stats()
        host_stats = self.host_stats(stats)
        fps10 = self.fps_tracker.fps(10)
        rewards = [es.avg_reward for es in self.episode_stats_per_policy]
        log.info("Fps: %.1f. Frames: %d. Per-policy avg rewards: %s", fps10, self.env_steps,
                 ["%.3f" % r if r is not None else "n/a" for r in rewards])
        for p in range(self.P):
            scalars = dict(host_stats[p])
            scalars["fps"] = fps10
            if rewards[p] is not None:
                scalars["reward"] = rewards[p]
            if self.pbt is not None:
                for name, value in self.pbt.policy_hparams[p].items():
                    scalars[f"pbt_{name}"] = value
            self.writers[p].write(self.env_steps, scalars)
            for obs in self.observers:
                obs.extra_summaries(self, p, self.writers[p], self.env_steps)
            self.writers[p].flush()

    def _close_writers(self) -> None:
        for w in self.writers:
            if w is not None:
                w.close()
        self.writer = None

    def _save(self, is_final: bool = False, milestone: bool = False) -> None:
        with self.timing.add_time("save"):
            for p, ts in enumerate(self.train_state):
                save_checkpoint(self.cfg, p, ts, self.env_steps, self.best_performance_per_policy[p], milestone=milestone)
        if is_final:
            with open(done_filename(self.cfg), "w") as f:
                f.write(str(self.env_steps))

    def _maybe_save_best(self) -> None:
        self._drain_ep_stats()
        if self.env_steps < self.cfg.save_best_after:
            return
        for p, ts in enumerate(self.train_state):
            metric = self.episode_stats_per_policy[p].avg_reward
            if metric is not None and metric - self.best_performance_per_policy[p] > 1e-9:
                self.best_performance_per_policy[p] = metric
                save_checkpoint(self.cfg, p, ts, self.env_steps, metric, is_best=True)
