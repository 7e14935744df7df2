"""The Runner: host-side orchestration of PPO/APPO on one device.

Counterpart of `sample_factory_tpu/runner/runner.py` (reference
`sample_factory/algo/runners/runner.py`: main loop, stats, periodic
checkpoint/summary timers, termination). Regimes:
  - sync (--async_rl=False): a rollout with the live parameters followed by the
    learner update (`train_iteration_sync`, :194-213); `--fused_iterations=K`
    runs K of them per iteration, with episodic sums added up.
  - async (--async_rl=True, the default): the rollout runs a behaviour model, a
    snapshot of the parameters with the version they had when it was taken
    (`train_iteration_async`, :215-223); after the train call the snapshot is
    refreshed for the next rollout (:258-260). The optimizer updates the
    trained model in place, so the snapshot is a second module that the
    parameters are copied into on the device. The version-stamped trajectory
    passes through the learner's policy-lag mask and V-trace.
Stats stay on the device until a report reads them.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import torch

from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.env_info import EnvInfo, extract_env_info
from sample_factory_tpu_torch.envs.env_utils import create_env
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint, save_checkpoint
from sample_factory_tpu_torch.runner.stats import EpisodeStats, FpsTracker, SummaryWriter
from sample_factory_tpu_torch.utils.timing import Timing
from sample_factory_tpu_torch.utils.utils import (
    done_filename,
    experiment_dir,
    init_file_logger,
    log,
    resolve_device,
    save_cfg,
)
from sample_factory_tpu_torch.utils.wandb_utils import finish_wandb, init_wandb

PROFILED_ITERATIONS = 12


class AlgoObserver:
    """User extension hooks on the training loop (reference runner.py:52-73)."""

    def on_init(self, runner) -> None:
        pass

    def on_training_iteration(self, runner, stats) -> None:
        """Called after every training iteration with a dict of device tensors."""

    def extra_summaries(self, runner, policy_id: int, writer, env_steps: int) -> None:
        """Called at every summary report; write custom scalars to the writer."""

    def on_stop(self, runner) -> None:
        pass


class Runner:
    """Single-policy, single-device, on-device-env training runner."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.policy_id = 0
        self.timing = Timing("runner")
        self.observers: list = []
        # custom per-episode stats: handlers called once an episode (host envs), and the
        # per-policy windows that observers fill and PBT reads for --pbt_target_objective
        self.episodic_stats_handlers: list = []
        self.policy_avg_stats: Dict[str, Any] = {}

        self.device: Optional[torch.device] = None
        self.env: Optional[DeviceEnv] = None
        self.env_info: Optional[EnvInfo] = None
        self.model = None
        self.train_state = None
        self.sampler_state = None
        self.behavior_model = None  # async regime: the rollout's snapshot of the parameters
        self.behavior_version = 0
        self.train_generator: Optional[torch.Generator] = None

        self.env_steps = 0
        self.best_performance = -1e9

        self.episode_stats = EpisodeStats(cfg.stats_avg)
        self.fps_tracker = FpsTracker()
        self.writer: Optional[SummaryWriter] = None

        self._rollout_fn = None
        self._train_fn = None
        self._fused_iterations = 1
        self._last_stats = None
        # episodic sums stay on the device until a report needs them: a fetch
        # every iteration would make the host wait for the device each time
        self._pending_ep: list = []
        self._max_pending_ep = 32
        self._last_report = 0.0
        self._last_checkpoint = 0.0
        self._last_best_check = 0.0
        self._last_milestone = 0.0
        self._start_time = None
        self._stop_requested = False

    # ------------------------------------------------------------------ init

    def _init_experiment(self):
        """Experiment directory, log file, saved config, the W&B run, device, env and its
        info. Every runner's `init` starts here, before it makes its summary writers."""
        cfg = self.cfg
        if cfg.restart_behavior == "overwrite":
            import shutil

            shutil.rmtree(experiment_dir(cfg, mkdir=False), ignore_errors=True)

        experiment_dir(cfg)  # create
        init_file_logger(cfg)
        save_cfg(cfg)
        init_wandb(cfg)
        self.device = resolve_device(cfg)
        self._init_env()

    def _init_env(self) -> None:
        """The env and its info. On-device envs are built here, in this process; the host
        runners probe theirs in a child process instead."""
        self.env = create_env(self.cfg.env, cfg=self.cfg, env_config=None)
        self.env_info = extract_env_info(self.env, self.cfg)

    def init(self) -> None:
        cfg = self.cfg
        self._init_experiment()
        env = self.env
        self.writer = SummaryWriter(cfg, self.policy_id)
        log.info("Runner: %d envs, rollout %d, device %s", cfg.num_envs, cfg.rollout, self.device)

        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, init_gen)
        self.model.to(self.device)
        self.train_state = init_train_state(cfg, self.env_info, self.model, self.device)
        sampler_gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.sampler_state = init_sampler_state(cfg, env, cfg.num_envs, self.device, sampler_gen)
        self.train_generator = torch.Generator(self.device).manual_seed(cfg.seed + 2)

        # resume from checkpoint (reference learner.py:300)
        restored = load_checkpoint(cfg, self.policy_id, self.train_state)
        if restored is not None:
            self.env_steps, self.best_performance = restored

        self._rollout_fn = make_rollout_fn(cfg, env, self.env_info)
        self._train_fn = make_train_fn(cfg, self.env_info, self.policy_id)
        fused = max(1, int(getattr(cfg, "fused_iterations", 1)))
        if cfg.async_rl:
            if fused > 1:
                log.warning("--fused_iterations>1 requires sync mode (async policy lag assumes K=1); using 1")
                fused = 1
            self.behavior_model = copy.deepcopy(self.model).requires_grad_(False)
            self.behavior_version = self.train_state.train_step
        self._fused_iterations = fused
        for obs in self.observers:
            obs.on_init(self)

    def train_iteration_sync(self):
        """On-policy: rollout with the live params, then train on it; K times with
        --fused_iterations=K (stats of the last, episodic sums of all)."""
        ts, ss = self.train_state, self.sampler_state
        ep_total = None
        for _ in range(self._fused_iterations):
            ss, traj, ep_stats = self._rollout_fn(ts.model, ts.obs_rms, ss, ts.train_step, self.policy_id)
            stats = self._train_fn(ts, traj, self.train_generator)
            ep_total = ep_stats if ep_total is None else {k: ep_total[k] + v for k, v in ep_stats.items()}
        self.sampler_state = ss
        return stats, ep_total

    def train_iteration_async(self):
        """Policy-lag regime: rollout with the behaviour snapshot and its version, train
        the live parameters, then refresh the snapshot for the next rollout."""
        ts = self.train_state
        self.sampler_state, traj, ep_stats = self._rollout_fn(
            self.behavior_model, ts.obs_rms, self.sampler_state, self.behavior_version, self.policy_id
        )
        stats = self._train_fn(ts, traj, self.train_generator)
        with torch.no_grad():
            torch._foreach_copy_(list(self.behavior_model.parameters()), list(ts.model.parameters()))
        self.behavior_version = ts.train_step
        return stats, ep_stats

    # ------------------------------------------------------------------- run

    def _train_iteration(self):
        return self.train_iteration_async() if self.cfg.async_rl else self.train_iteration_sync()

    def _transitions_per_iteration(self) -> int:
        return self.cfg.num_envs * self.cfg.rollout * self._fused_iterations

    def _after_iteration(self) -> None:
        """Between an iteration's bookkeeping and its periodic tasks (the population runner's PBT step)."""

    def _finish_pending_work(self) -> None:
        """Before the final checkpoint (the host runner dispatches the learner quanta still queued)."""

    def _release_resources(self) -> None:
        """At the very end of run(), whatever happened (the host runners stop their env workers)."""

    def _close_writers(self) -> None:
        if self.writer is not None:
            self.writer.close()

    def run(self) -> int:
        cfg = self.cfg
        self._start_time = time.time()
        self._last_report = self._last_checkpoint = self._last_best_check = self._last_milestone = self._start_time
        transitions_per_iter = self._transitions_per_iteration()
        frameskip = cfg.env_frameskip if cfg.summaries_use_frameskip else 1

        log.info("Starting training for %d env steps (current: %d)", cfg.train_for_env_steps, self.env_steps)
        status = 0
        profiler = self._start_profiler()
        iterations = 0
        try:
            while not self._should_end_training():
                stats, ep_stats = self._train_iteration()
                iterations += 1
                if profiler is not None and iterations == PROFILED_ITERATIONS:
                    self._stop_profiler(profiler)
                    profiler = None
                self.env_steps += transitions_per_iter * frameskip
                self._process_stats(stats, ep_stats)
                self._after_iteration()
                self._periodic_tasks(stats)
                self._notify_observers(stats)
        except KeyboardInterrupt:
            log.info("Interrupted, saving checkpoint...")
            status = 1
        finally:
            try:
                if profiler is not None:
                    self._stop_profiler(profiler)
                self._finish_pending_work()
                self._drain_ep_stats()
                self._save(is_final=True)
            finally:
                self._release_resources()
                self._close_writers()
                finish_wandb(self.cfg)
            for obs in self.observers:
                obs.on_stop(self)
            log.info("Timing: %s", self.timing.flat_str())
        fps = self.fps_tracker.fps(300)
        log.info("Training finished at %d env steps, avg FPS (5min window): %.1f", self.env_steps, fps)
        return status

    def stop(self) -> None:
        self._stop_requested = True

    def register_observer(self, observer: AlgoObserver) -> None:
        self.observers.append(observer)

    def register_episodic_stats_handler(self, fn) -> None:
        """fn(runner, extra_stats: Dict[str, float], policy_id) is called once per completed
        episode that carried `episode_extra_stats` in its final info dict (reference
        Runner.register_episodic_stats_handler)."""
        self.episodic_stats_handlers.append(fn)

    def _dispatch_extra_stats(self, extra_stats_list, policy_id: int) -> None:
        for extras in extra_stats_list:
            for handler in self.episodic_stats_handlers:
                handler(self, extras, policy_id)

    def _notify_observers(self, stats) -> None:
        for obs in self.observers:
            obs.on_training_iteration(self, stats)

    # ------------------------------------------------------------- internals

    def _start_profiler(self):
        if not self.cfg.profiler_dir:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        os.makedirs(self.cfg.profiler_dir, exist_ok=True)
        path = os.path.join(self.cfg.profiler_dir, "trace.json")
        profiler.export_chrome_trace(path)
        log.info("torch.profiler trace of the first iterations written to %s", path)

    def _should_end_training(self) -> bool:
        if self._stop_requested:
            return True
        if self.env_steps >= self.cfg.train_for_env_steps:
            return True
        return time.time() - self._start_time >= self.cfg.train_for_seconds

    def _process_stats(self, stats: Dict[str, Any], ep_stats: Dict[str, Any]) -> None:
        self.fps_tracker.add(time.time(), self.env_steps)
        self._pending_ep.append(ep_stats)
        if len(self._pending_ep) >= self._max_pending_ep:
            self._drain_ep_stats()
        self._last_stats = stats  # device tensors; read at report time

    def _drain_ep_stats(self) -> None:
        """Fetch all pending episodic sums at once."""
        if not self._pending_ep:
            return
        pending, self._pending_ep = self._pending_ep, []
        keys = ("count", "return_sum", "len_sum")
        host = torch.stack([torch.stack([ep[k].float() for k in keys]) for ep in pending]).cpu().tolist()
        for count, return_sum, len_sum in host:
            self.episode_stats.add_rollout_stats(count, return_sum, len_sum)

    def _periodic_tasks(self, stats) -> None:
        cfg = self.cfg
        now = time.time()
        if now - self._last_report >= cfg.experiment_summaries_interval:
            self._report(stats)
            self._last_report = now
        if now - self._last_checkpoint >= cfg.save_every_sec:
            self._save()
            self._last_checkpoint = now
        if cfg.save_milestones_sec > 0 and now - self._last_milestone >= cfg.save_milestones_sec:
            self._save(milestone=True)
            self._last_milestone = now
        if now - self._last_best_check >= cfg.save_best_every_sec:
            self._maybe_save_best()
            self._last_best_check = now

    def host_stats(self, stats=None) -> Dict[str, float]:
        stats = self._last_stats if stats is None else stats
        if not stats:
            return {}
        values = torch.stack([v.detach().float().reshape(()) for v in stats.values()]).cpu().tolist()
        return dict(zip(stats.keys(), values))

    def _report(self, stats) -> None:
        self._drain_ep_stats()
        scalars = self.host_stats(stats)
        fps10, fps300 = self.fps_tracker.fps(10), self.fps_tracker.fps(300)
        avg_r = self.episode_stats.avg_reward
        avg_len = self.episode_stats.avg_length
        log.info(
            "Fps is (10 sec: %.1f, 5 min: %.1f). Total num frames: %d. Throughput: %d episodes. "
            "Avg episode reward: %s, avg episode len: %s",
            fps10,
            fps300,
            self.env_steps,
            self.episode_stats.total_episodes,
            f"{avg_r:.3f}" if avg_r is not None else "n/a",
            f"{avg_len:.1f}" if avg_len is not None else "n/a",
        )
        scalars["fps"] = fps10
        if avg_r is not None:
            scalars["reward"] = avg_r
            scalars["episode_len"] = avg_len
        self.writer.write(self.env_steps, scalars)
        for obs in self.observers:
            obs.extra_summaries(self, self.policy_id, self.writer, self.env_steps)
        self.writer.flush()

    def _save(self, is_final: bool = False, milestone: bool = False) -> None:
        with self.timing.add_time("save"):
            save_checkpoint(
                self.cfg, self.policy_id, self.train_state, self.env_steps, self.best_performance, milestone=milestone
            )
        if is_final:
            with open(done_filename(self.cfg), "w") as f:
                f.write(str(self.env_steps))

    def _maybe_save_best(self) -> None:
        self._drain_ep_stats()
        metric = self.episode_stats.avg_reward
        if metric is None or self.env_steps < self.cfg.save_best_after:
            return
        if metric - self.best_performance > 1e-9:
            self.best_performance = metric
            save_checkpoint(
                self.cfg, self.policy_id, self.train_state, self.env_steps, self.best_performance, is_best=True
            )
