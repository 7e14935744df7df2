"""Runner for host (gymnasium) environments: CPU env workers and the learner on the device.

Counterpart of `sample_factory_tpu/runner/host_runner.py`, without its
multi-host branches. The host analog of `Runner`: rollouts come from
`HostVectorSampler` worker processes through shared-memory slabs, and the run
loop, reports and checkpoints are `Runner`'s.

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
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional

import torch

from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler
from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.quantized_train import QuantizedTrainer
from sample_factory_tpu_torch.envs.env_info import obtain_env_info
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.runner.runner import Runner
from sample_factory_tpu_torch.runner.stats import SummaryWriter
from sample_factory_tpu_torch.utils.utils import log


class _QuantaPacer:
    """Paces learner-quantum dispatch evenly over a rollout's idle slots.

    With Q pending quanta and S slots, slot i dispatches up to ceil(Q*i/S)
    cumulative quanta: one per slot when Q <= S, bursts when the train step
    is bigger than the rollout's slot count (large num_epochs / many
    minibatches), so the full step is always in flight by rollout end.
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

        self.sampler = HostVectorSampler(cfg, self.env_info, self.device, register_fn=self.register_fn)
        # keep cfg.num_envs consistent with the actual host vector size
        cfg.num_envs = self.sampler.num_envs
        try:
            self.sampler.start()
        except BaseException:
            self.sampler.close()
            raise

        restored = load_checkpoint(cfg, self.policy_id, self.train_state)
        if restored is not None:
            self.env_steps, self.best_performance = restored
        self._version_host = self._behavior_version_host = self.train_state.train_step

        self._train_fn = make_train_fn(cfg, self.env_info, self.policy_id)
        # async mode trains through the quantized scheduler: learner quanta are dispatched
        # into the slots between inference steps, so that env workers never wait for training
        if cfg.async_rl:
            self.behavior_model = copy.deepcopy(self.model).requires_grad_(False)
            self.behavior_obs_rms = self.train_state.obs_rms
            self._quantizer = QuantizedTrainer(cfg, self.env_info, self.policy_id, num_envs=self.sampler.num_envs)
            self._pacer = _QuantaPacer(self._quantizer, slots=cfg.rollout * cfg.worker_num_splits)
        log.info(
            "HostEnvRunner: %d workers x %d envs (%d total), serial=%s, async=%s, transport=%s, device %s",
            cfg.num_workers, cfg.num_envs_per_worker, self.sampler.num_envs, cfg.serial_mode, cfg.async_rl,
            self.sampler.transport, self.device,
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
        return self.sampler.num_envs * self.cfg.rollout

    def _process_stats(self, stats, ep_stats) -> None:
        """Episodic sums of a host env arrive as host numbers with every rollout: nothing is
        kept pending on the device."""
        self.fps_tracker.add(time.time(), self.env_steps)
        self.episode_stats.add_rollout_stats(ep_stats["count"], ep_stats["return_sum"], ep_stats["len_sum"])
        self._dispatch_extra_stats(ep_stats.get("extra_stats", ()), self.policy_id)
        if stats:
            self._last_stats = stats

    def _finish_pending_work(self) -> None:
        if self._pending:
            self._quantizer.flush()
            self._pending = False

    def _release_resources(self) -> None:
        if self.sampler is not None:
            self.sampler.close()
