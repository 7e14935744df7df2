"""Runner for host (gymnasium) environments: CPU env workers and the learner on the device.

Counterpart of `sample_factory_tpu/runner/host_runner.py`. The host analog of
`Runner`: rollouts come from `HostVectorSampler` worker processes through
shared-memory slabs, and the run loop, reports and checkpoints are `Runner`'s.

Sync mode (--async_rl=False) trains with one fused train call after each
rollout, on the live parameters (on-policy).

Async mode (the default) overlaps the two (reference
docs/06-architecture/overview.md, inference_worker.py:349-368): the train step
is cut into learner quanta (`algo/quantized_train.py`) that are dispatched into
the slots between the rollout's inference steps, paced evenly over the rollout.
The quanta update the live module in place while the rollout is under way, so
the rollout runs a second module, the behaviour snapshot: after the previous
train step's quanta are flushed and before the next one's are queued, the live
parameters are copied into it with one `torch._foreach_copy_`, together with the
observation normalizer and the version that is stamped on the trajectory. The
version is kept on the host (`_version_host`: `sgd_steps_per_train` a train
step, corrected by what an early stop skipped), so stamping it never waits for
the device. Stats lag by one iteration: flush() returns those of the train step
queued an iteration ago.

Data parallelism (`--jax_distributed=True`, the JAX runner's multi-process branch,
:95-107, 166-204, 249-255): every rank runs its own sampler over its own
`--num_workers x --num_envs_per_worker` envs, seeded RANK_SEED_STRIDE apart
(`cfg.env_seed_offset`, and the sampler's action draws), from rank 0's train state and env steps,
and the learner (fused or quantized) reduces over the ranks, so that R ranks compute
what one rank computes on their trajectories joined on the env axis in rank order.
Env steps count every rank's experience. The episode sums and the stop go into the
iteration's one all-reduce and are read back one iteration late
(`Runner._reduce_host_sums`), so a stop takes effect an iteration later than on the
device-env runner. The behaviour snapshot and the version mirror stay per rank: they
are equal on every rank because the parameters are. Rank 0 alone writes.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import numpy as np
import torch

from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.quantized_train import QuantizedTrainer
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.parallel.mesh import replicate_tree
from sample_factory_tpu_torch.parallel.multihost import RANK_SEED_STRIDE, broadcast_from_primary
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.runner.runner import EPISODIC_KEYS, Runner
from sample_factory_tpu_torch.runner.stats import SummaryWriter
from sample_factory_tpu_torch.utils.utils import log


class _QuantaPacer:
    """Paces learner-quantum dispatch evenly over a rollout's idle slots.

    With Q pending quanta and S slots, slot i dispatches up to ceil(Q*i/S)
    cumulative quanta: one per slot when Q <= S, bursts when the train step
    is bigger than the rollout's slot count (large num_epochs / many
    minibatches), so the full step is always in flight by rollout end.
    Which quanta go out at a slot depends on the slot's index and the queue
    alone, never on a clock: under a process group the quanta carry
    collectives, and every rank must dispatch the same quantum at the same slot.
    """

    def __init__(self, quantizer: QuantizedTrainer, slots: int):
        self.q = quantizer
        self.slots = max(1, slots)
        self.total = 0
        self.i = 0

    def reset(self) -> None:
        self.total = self.q.pending
        self.i = 0

    def __call__(self) -> None:
        self.i += 1
        target = min(self.total, -(-self.total * self.i // self.slots))  # ceil
        while (self.total - self.q.pending) < target:
            if not self.q.dispatch_one():
                break


class HostEnvRunner(Runner):
    shards_params = False  # the JAX host runner only replicates on its mesh: --mesh_model > 1 is refused (train.py)

    def __init__(self, cfg, register_fn: Optional[Callable] = None):
        super().__init__(cfg)
        self.register_fn = register_fn
        self.sampler: Optional[HostVectorSampler] = None
        self.behavior_obs_rms = None
        self._quantizer: Optional[QuantizedTrainer] = None
        self._pacer: Optional[_QuantaPacer] = None
        self._pending = False  # a train step's quanta are queued or under way
        self._version_host = 0  # the policy version once every queued quantum has run
        self._behavior_version_host = 0  # the version of the behaviour snapshot

    def _init_env(self) -> None:
        self.env_info = obtain_env_info(self.cfg, register_fn=self.register_fn)
        assert not self.env_info.is_device_env

    def init(self) -> None:
        cfg = self.cfg
        self._init_experiment()
        self.writer = SummaryWriter(cfg, self.policy_id)

        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, init_gen)
        self.model.to(self.device)
        self.train_state = init_train_state(cfg, self.env_info, self.model, self.device)
        self.train_generator = torch.Generator(self.device).manual_seed(cfg.seed + 2)

        if self.mesh.distributed:
            cfg.env_seed_offset = self.mesh.rank * RANK_SEED_STRIDE  # this rank's envs step their own episodes
        self.sampler = HostVectorSampler(cfg, self.env_info, self.device, register_fn=self.register_fn)
        # keep cfg.num_envs consistent with the actual host vector size (this rank's)
        cfg.num_envs = self.sampler.num_envs
        try:
            self.sampler.start()
        except BaseException:
            self.sampler.close()
            raise

        restored = load_checkpoint(cfg, self.policy_id, self.train_state)
        if restored is not None:
            self.env_steps, self.best_performance = restored
        replicate_tree(self.train_state, self.mesh)
        self.env_steps, self.best_performance = broadcast_from_primary((self.env_steps, self.best_performance))
        self._version_host = self._behavior_version_host = self.train_state.train_step

        self._train_fn = make_train_fn(cfg, self.env_info, self.policy_id, self.mesh)
        # async mode trains through the quantized scheduler: learner quanta are dispatched
        # into the slots between inference steps, so that env workers never wait for training
        if cfg.async_rl:
            self.behavior_model = copy.deepcopy(self.model).requires_grad_(False)
            self.behavior_obs_rms = self.train_state.obs_rms
            self._quantizer = QuantizedTrainer(cfg, self.env_info, self.policy_id, num_envs=self.sampler.num_envs, mesh=self.mesh)
            self._pacer = _QuantaPacer(self._quantizer, slots=cfg.rollout * cfg.worker_num_splits)
        log.info(
            "HostEnvRunner: %d workers x %d envs (%d total), serial=%s, async=%s, transport=%s, device %s, rank %d of %d",
            cfg.num_workers, cfg.num_envs_per_worker, self.sampler.num_envs, cfg.serial_mode, cfg.async_rl,
            self.sampler.transport, self.device, self.mesh.rank, self.mesh.world,
        )
        for obs in self.observers:
            obs.on_init(self)

    # ------------------------------------------------------------- iteration

    def _refresh_behavior(self) -> None:
        """The live parameters, normalizer and version become the next rollout's behaviour
        policy. Called with no quantum pending: the copy reads a finished train step."""
        ts = self.train_state
        with torch.no_grad():
            torch._foreach_copy_(list(self.behavior_model.parameters()), list(ts.model.parameters()))
        self.behavior_obs_rms = ts.obs_rms  # updates build new tensors, so a reference is a snapshot
        self._behavior_version_host = self._version_host

    def _train_iteration(self):
        cfg, ts = self.cfg, self.train_state
        if cfg.async_rl:
            model, obs_rms, version = self.behavior_model, self.behavior_obs_rms, self._behavior_version_host
        else:
            model, obs_rms, version = ts.model, ts.obs_rms, ts.train_step

        idle_fn = self._pacer if self._pending else None
        with self.timing.add_time("rollout"):
            traj, ep_stats = self.sampler.collect_rollout(model, obs_rms, version, self.policy_id, idle_fn=idle_fn)

        stats = None
        if self._quantizer is not None:
            if self._pending:
                with self.timing.add_time("train_flush"):
                    stats = self._quantizer.flush()
                # an early stop skipped sgd quanta: bring the mirror back to the train state's
                # count (the one rollout stamped before this correction reads as a negative
                # lag, which the max_policy_lag check treats as fresh: the safe direction)
                self._version_host -= self._quantizer.last_skipped_sgd_steps
                assert self._version_host == ts.train_step
            # the next rollout's behaviour: the parameters the train step queued below will
            # start from, produced by the previous train step, whose quanta ran during this rollout
            self._refresh_behavior()
            with self.timing.add_time("train_dispatch"):
                self._quantizer.enqueue(ts, traj, self.train_generator)
            self._pacer.reset()
            self._version_host += self._quantizer.sgd_steps_per_train
            self._pending = True
        else:
            with self.timing.add_time("train"):
                stats = self._train_fn(ts, traj, self.train_generator)
        # async: on the first iteration there are no stats yet; observers always get a dict
        return (stats if stats is not None else (self._last_stats or {})), ep_stats

    def _transitions_per_iteration(self) -> int:
        return self.sampler.num_envs * self.cfg.rollout * self.mesh.world

    def _process_stats(self, stats, ep_stats) -> None:
        """Episodic sums of a host env arrive as host numbers with every rollout. Under a group
        they are summed over the ranks in the iteration's one all-reduce, with the stop, and
        counted an iteration later; the custom per-episode stats stay the rank's own."""
        self.fps_tracker.add(time.time(), self.env_steps)
        sums = np.asarray([ep_stats[k] for k in EPISODIC_KEYS])
        self._add_episode_sums(self._reduce_host_sums(sums) if self.mesh.distributed else sums)
        self._dispatch_extra_stats(ep_stats.get("extra_stats", ()), self.policy_id)
        if stats:
            self._last_stats = stats

    def _add_episode_sums(self, sums) -> None:
        if sums is not None:
            self.episode_stats.add_rollout_stats(*(float(v) for v in sums))

    def _finish_pending_work(self) -> None:
        if self._pending:
            self._quantizer.flush()
            self._pending = False
        self._add_episode_sums(self._last_host_sums())

    def _release_resources(self) -> None:
        if self.sampler is not None:
            self.sampler.close()
