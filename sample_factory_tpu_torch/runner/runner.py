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

Data parallelism (`--jax_distributed=True`, `parallel/mesh.py`): rank r of R steps envs
[r·N/R, (r+1)·N/R) of the `--num_envs` N, from a train state broadcast from rank 0 after
init (and resume), and the learner's reductions are global, so that the ranks compute
what one rank with N envs computes (runner.py:147-180). Every iteration one all-reduce
sums the episode stats and agrees on the stop, so that every rank runs the same
iterations: the JAX runner reads each process's own clock (ROADMAP C). Only rank 0
writes checkpoints and summaries; every rank loads the same checkpoint on resume.

Tensor parallelism (`--mesh_model=M > 1`, this runner alone): the ranks of a model group step
the same envs (their data index picks them) and share one replica of the train state, each
holding its shards of the wide leaves, cut from the whole state after init and resume
(`shard_train_state`). The rollout acts with a whole copy of the parameters, gathered once a
rollout, in either regime. Every rank of a model group gathers the shards before a save, so
the saves must fall on the same iterations everywhere: their timers' verdicts join the
iteration's all-reduce, as the stop does. The model group's first rank alone contributes the
episode sums to it: the others stepped the same episodes. And each rank puts in a checksum of
its rollouts' actions: should two ranks of a model group ever act differently, their envs
would part for good, so the run stops there with an error.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sample_factory_tpu_torch.algo.learning import init_train_state, make_train_fn
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
from sample_factory_tpu_torch.envs.device_env import DeviceEnv
from sample_factory_tpu_torch.envs.env_info import EnvInfo, extract_env_info
from sample_factory_tpu_torch.envs.env_utils import create_env
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.parallel.mesh import make_mesh, replicate_tree, shard_env_axis, shard_train_state
from sample_factory_tpu_torch.parallel.multihost import agree_on_stop, all_reduce, broadcast_from_primary, is_primary_host, sync_barrier
from sample_factory_tpu_torch.runner.checkpoint import full_state_dict, load_checkpoint, save_checkpoint
from sample_factory_tpu_torch.runner.stats import EpisodeStats, FpsTracker, SummaryWriter
from sample_factory_tpu_torch.utils.timing import Timing, tracer
from sample_factory_tpu_torch.utils.utils import (
    done_filename,
    experiment_dir,
    init_file_logger,
    log,
    save_cfg,
)
from sample_factory_tpu_torch.utils.wandb_utils import finish_wandb, init_wandb

ACTIONS_CHECKSUM_PRIME = 9973  # `_tally_actions` weighs the action at place i by 1 + i mod this
PROFILE_AFTER = 4  # --profiler_dir: iterations left out of the profile first (warm-up)
PROFILED_ITERATIONS = 4  # then profiled
EPISODIC_KEYS = ("count", "return_sum", "len_sum")


class AlgoObserver:
    """User extension hooks on the training loop (reference runner.py:52-73)."""

    def on_init(self, runner) -> None:
        pass

    def on_training_iteration(self, runner, stats) -> None:
        """Called after every training iteration with a dict of device tensors."""

    def span(self, name: str, start_s: float, end_s: float) -> None:
        """Called as each span of the program's tracer ends (`utils/timing.py`: only while a torch.profiler
        session records), with its ends in `time.perf_counter` seconds."""

    def extra_summaries(self, runner, policy_id: int, writer, env_steps: int) -> None:
        """Called at every summary report; write custom scalars to the writer."""

    def on_stop(self, runner) -> None:
        pass


class Runner:
    """Single-policy, on-device-env training runner: one device, or one rank of a data-parallel run."""

    shards_envs = True  # under a process group each rank steps its own envs
    # tensor parallelism (--mesh_model > 1): this runner only, as in the JAX package
    # (runner/runner.py:176-180); its host and population runners replicate on their mesh
    shards_params = True

    def __init__(self, cfg):
        self.cfg = cfg
        self.policy_id = 0
        self.timing = Timing()
        self.observers: list = []
        # custom per-episode stats: handlers called once an episode (host envs), and the
        # per-policy windows that observers fill and PBT reads for --pbt_target_objective
        self.episodic_stats_handlers: list = []
        self.policy_avg_stats: Dict[str, Any] = {}

        self.mesh = None
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
        self._agreed_stop = None  # under a process group: the stop the ranks agreed on last iteration
        self._agreed_writes = None  # under tensor parallelism: the saves the ranks agreed on this iteration
        self._actions_checksum = 0.0  # under tensor parallelism: of this iteration's rollouts, see `_tally_actions`
        self._pending_host_sums = None  # host runners under a group: the last iteration's reduce, read one iteration late

    # ------------------------------------------------------------------ init

    def _init_experiment(self):
        """Experiment directory, log file, saved config, the W&B run, mesh, device, env and its
        info. Every runner's `init` starts here, before it makes its summary writers. Under a
        process group rank 0 alone clears, records and reports the experiment."""
        cfg = self.cfg
        self.mesh = make_mesh(cfg)
        if self.mesh.distributed:
            # a seed drawn from the OS (no --seed) differs between the processes: every rank takes rank 0's
            cfg.seed = broadcast_from_primary(cfg.seed)
        primary = is_primary_host()
        sync_barrier("config_read")  # every rank has read the saved config (make_rl_runner) before rank 0 rewrites it
        if primary:
            if cfg.restart_behavior == "overwrite":
                import shutil

                shutil.rmtree(experiment_dir(cfg, mkdir=False), ignore_errors=True)
            experiment_dir(cfg)  # create
            save_cfg(cfg)
        sync_barrier("experiment_dir")  # no rank opens a file in the directory before rank 0 has made it

        experiment_dir(cfg)
        init_file_logger(cfg)
        if primary:
            init_wandb(cfg)
        self.device = self.mesh.device
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
        shard = shard_env_axis(self.mesh, cfg.num_envs)  # raises unless num_envs divides over the data shards
        log.info("Runner: %d envs, rollout %d, mesh %s, device %s, envs [%d, %d) on rank %d", cfg.num_envs, cfg.rollout,
                 self.mesh.shape, self.device, shard.start, shard.stop, self.mesh.rank)

        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, init_gen)
        self.model.to(self.device)
        self.train_state = init_train_state(cfg, self.env_info, self.model, self.device)
        sampler_gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.sampler_state = init_sampler_state(cfg, env, shard.size, self.device, sampler_gen, shard if self.mesh.distributed else None)
        self.train_generator = torch.Generator(self.device).manual_seed(cfg.seed + 2)

        # resume from checkpoint (reference learner.py:300); under a group every rank takes rank 0's
        restored = load_checkpoint(cfg, self.policy_id, self.train_state)
        if restored is not None:
            self.env_steps, self.best_performance = restored
        replicate_tree(self.train_state, self.mesh)
        self.env_steps, self.best_performance = broadcast_from_primary((self.env_steps, self.best_performance))
        shard_train_state(self.train_state, self.mesh, cfg.tp_min_layer_width)

        self._rollout_fn = make_rollout_fn(cfg, env, self.env_info)
        self._train_fn = make_train_fn(cfg, self.env_info, self.policy_id, self.mesh)
        fused = max(1, int(getattr(cfg, "fused_iterations", 1)))
        if cfg.async_rl:
            if fused > 1:
                log.warning("--fused_iterations>1 requires sync mode (async policy lag assumes K=1); using 1")
                fused = 1
        tp = self.train_state.tp
        if cfg.async_rl or tp is not None:
            self.behavior_model = copy.deepcopy(self.model).requires_grad_(False) if tp is None else tp.whole_model(self.model)
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
            model = ts.model if ts.tp is None else self._update_behavior_model()
            ss, traj, ep_stats = self._rollout_fn(model, ts.obs_rms, ss, ts.train_step, self.policy_id)
            self._tally_actions(traj)
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
        self._tally_actions(traj)
        stats = self._train_fn(ts, traj, self.train_generator)
        self._update_behavior_model()
        self.behavior_version = ts.train_step
        return stats, ep_stats

    def _update_behavior_model(self):
        """The behaviour module from the live parameters; returns it. Under tensor parallelism it
        holds them whole: one all-gather of the shards, after which a rollout makes no collective."""
        ts = self.train_state
        if ts.tp is not None:
            ts.tp.gather_into(self.behavior_model, ts.model)
        else:
            with torch.no_grad():
                torch._foreach_copy_(list(self.behavior_model.parameters()), list(ts.model.parameters()))
        return self.behavior_model

    def _tally_actions(self, traj) -> None:
        """On a mesh with a model axis: add a checksum of the rollout's actions (each weighted by
        its place, so that a swap shows) to the iteration's, which `_process_stats` holds equal
        across each model group."""
        if self.mesh.model > 1:
            actions = traj["actions"].reshape(-1).double()
            place = torch.arange(actions.numel(), device=actions.device, dtype=torch.float64).remainder_(ACTIONS_CHECKSUM_PRIME)
            self._actions_checksum = self._actions_checksum + (actions * (place + 1)).sum()

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
        profiler = None
        iterations = 0
        trace = tracer()
        trace.clear()
        try:
            while not self._should_end_training():
                trace.begin_iteration(self.observers)
                with trace.span("iteration"):
                    stats, ep_stats = self._train_iteration()
                    self.env_steps += transitions_per_iter * frameskip
                    self._process_stats(stats, ep_stats)
                    self._after_iteration()
                    self._periodic_tasks(stats)
                self._notify_observers(stats)
                iterations += 1
                if self.cfg.profiler_dir and iterations == PROFILE_AFTER:
                    profiler = self._start_profiler()
                elif profiler is not None and iterations == PROFILE_AFTER + PROFILED_ITERATIONS:
                    self._stop_profiler(profiler)
                    profiler = None
        except KeyboardInterrupt:
            log.info("Interrupted, saving checkpoint...")
            status = 1
        finally:
            trace.end()
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
        """--profiler_dir: the iterations after the first PROFILE_AFTER, host and device on one clock, with the
        tracer's spans (on while the profiler records) over the kernels."""
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
        log.info("torch.profiler trace of iterations %d-%d written to %s", PROFILE_AFTER + 1,
                 PROFILE_AFTER + PROFILED_ITERATIONS, path)

    def _wants_to_stop(self) -> bool:
        if self._stop_requested:
            return True
        if self.env_steps >= self.cfg.train_for_env_steps:
            return True
        return time.time() - self._start_time >= self.cfg.train_for_seconds

    def _should_end_training(self) -> bool:
        if not self.mesh.distributed:
            return self._wants_to_stop()
        if self.env_steps >= self.cfg.train_for_env_steps:
            return True  # every rank's experience, from rank 0's count at init: the same on every rank
        if self._agreed_stop is None:  # before the first iteration
            self._agreed_stop = torch.tensor(float(agree_on_stop(self._wants_to_stop())))
        return bool(tracer().host_read("stop", self._agreed_stop) > 0)

    def _reduce_across_ranks(self, sums: List[torch.Tensor], dtype: torch.dtype = torch.float32):
        """One all-reduce an iteration, on every rank: `sums` (this rank's parts, on the
        device) and the stop flags, of which any one stops every rank. Returns the global sums
        and the agreed stop flag, on the device, without waiting for them."""
        flag = torch.full((), float(self._wants_to_stop()), device=self.device)
        *sums, stop = all_reduce(list(sums) + [flag], dtype=dtype)
        return sums, stop

    def _reduce_host_sums(self, sums: np.ndarray) -> Optional[np.ndarray]:
        """The host runners' form of the iteration's one all-reduce: episode sums that are host
        numbers go up without waiting for the stream (on NCCL they travel through the card) and
        come back into pinned host memory behind an event, read one iteration late: the read
        waits for the stream up to the reduce, not for the learner's quanta dispatched after
        it. Returns the previous iteration's global sums, None on the first; their agreed stop
        takes effect before the iteration after next."""
        up = torch.from_numpy(np.asarray(sums, np.float64)).to(self.device, non_blocking=True)
        (reduced,), stop = self._reduce_across_ranks([up], dtype=torch.float64)
        packed, done = torch.cat([reduced.reshape(-1), stop.reshape(1)]), None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            packed, done = host, torch.cuda.Event()
            done.record()
        previous, self._pending_host_sums = self._pending_host_sums, (packed, done, reduced.shape)
        return None if previous is None else self._read_host_sums(previous)

    def _read_host_sums(self, pending) -> np.ndarray:
        host, done, shape = pending
        if done is not None:
            done.synchronize()
        self._agreed_stop = host[-1]
        return host[:-1].reshape(shape).numpy()

    def _last_host_sums(self) -> Optional[np.ndarray]:
        """At the end of a run: the last iteration's global sums, still pending."""
        pending, self._pending_host_sums = self._pending_host_sums, None
        return None if pending is None else self._read_host_sums(pending)

    def _process_stats(self, stats: Dict[str, Any], ep_stats: Dict[str, Any]) -> None:
        if self.mesh.distributed:
            keys = EPISODIC_KEYS if self.shards_envs else ()
            sums = [ep_stats[k] for k in keys]
            if self.mesh.model > 1:
                # one rank of each model group counts its episodes; the saves' timers and each rank's
                # checksum of its actions (in its own slot) join the reduce
                sums = [v if self.mesh.model_index == 0 else torch.zeros_like(v) for v in sums]
                sums.append(torch.tensor(self._writes_due(time.time()), dtype=torch.float32).to(self.device))
                checksums = torch.zeros(self.mesh.world, device=self.device)
                checksums[self.mesh.rank] = self._actions_checksum
                sums.append(checksums)
                self._actions_checksum = 0.0
            sums, self._agreed_stop = self._reduce_across_ranks(sums)
            if self.mesh.model > 1:
                checksums, writes = sums.pop(), sums.pop()
                host = tracer().host_read("agree", torch.cat([writes, checksums])).tolist()
                self._agreed_writes = tuple(v > 0 for v in host[:3])
                self._check_model_groups_agree(host[3:])
            ep_stats = {**ep_stats, **dict(zip(keys, sums))}
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
        sums = torch.stack([torch.stack([ep[k].float() for k in keys]) for ep in pending])
        host = tracer().host_read("episode_stats", sums).tolist()
        for count, return_sum, len_sum in host:
            self.episode_stats.add_rollout_stats(count, return_sum, len_sum)

    def _check_model_groups_agree(self, checksums: List[float]) -> None:
        """Raise, on every rank alike, where the ranks of a model group acted differently."""
        model = self.mesh.model
        for d in range(self.mesh.data):
            group = checksums[d * model : (d + 1) * model]
            if len(set(group)) > 1:
                raise RuntimeError(
                    f"the ranks of model group {d} (ranks {d * model}-{(d + 1) * model - 1}) sampled different actions "
                    f"(checksums {group}): their envs have parted, and tensor parallelism needs them to step alike"
                )

    def _writes_due(self, now: float):
        """(checkpoint, milestone, best check) due by this rank's clock."""
        cfg = self.cfg
        return (now - self._last_checkpoint >= cfg.save_every_sec,
                cfg.save_milestones_sec > 0 and now - self._last_milestone >= cfg.save_milestones_sec,
                now - self._last_best_check >= cfg.save_best_every_sec)

    def _periodic_tasks(self, stats) -> None:
        cfg = self.cfg
        now = time.time()
        if now - self._last_report >= cfg.experiment_summaries_interval:
            self._report(stats)
            self._last_report = now
        checkpoint, milestone, best = self._writes_due(now) if self._agreed_writes is None else self._agreed_writes
        if checkpoint:
            self._save()
            self._last_checkpoint = now
        if milestone:
            self._save(milestone=True)
            self._last_milestone = now
        if best:
            self._maybe_save_best()
            self._last_best_check = now

    def host_stats(self, stats=None) -> Dict[str, float]:
        stats = self._last_stats if stats is None else stats
        if not stats:
            return {}
        stacked = torch.stack([v.detach().float().reshape(()) for v in stats.values()])
        values = tracer().host_read("report", stacked).tolist()
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
        state = full_state_dict(self.train_state)  # on every rank: under tensor parallelism a gather
        if not is_primary_host():
            return  # a shared file system: rank 0 writes for every rank
        with self.timing.add_time("save"):
            save_checkpoint(
                self.cfg, self.policy_id, self.train_state, self.env_steps, self.best_performance, milestone=milestone,
                state=state,
            )
        if is_final:
            with open(done_filename(self.cfg), "w") as f:
                f.write(str(self.env_steps))

    def _maybe_save_best(self) -> None:
        """On every rank: the episode stats are the global ones everywhere, so the ranks agree on
        the verdict, and under tensor parallelism each joins the gather."""
        self._drain_ep_stats()
        metric = self.episode_stats.avg_reward
        if metric is None or self.env_steps < self.cfg.save_best_after:
            return
        if metric - self.best_performance > 1e-9:
            self.best_performance = metric
            state = full_state_dict(self.train_state)
            if is_primary_host():
                save_checkpoint(
                    self.cfg, self.policy_id, self.train_state, self.env_steps, self.best_performance, is_best=True,
                    state=state,
                )
