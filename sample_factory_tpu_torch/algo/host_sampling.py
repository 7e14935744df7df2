"""Host-env sampler: CPU (gymnasium) envs feeding the device pipeline.

Counterpart of `sample_factory_tpu/algo/host_sampling.py:504-947`
(`HostVectorSampler`). Worker processes step the envs and exchange data with
this process through preallocated shared-memory slabs; only small control
messages cross the queue or pipe. Double buffering via --worker_num_splits
overlaps env stepping of one split with inference for the other (the
reference's `advance_rollouts` ping-pong, rollout_worker.py:176-259, without a
separate inference-worker process). The worker half (`ShmSlabs`,
`EnvSlotStepper`, `host_env_worker`) is numpy only and lives in
`algo/host_worker.py`; its names are re-exported here.

The trajectory has the schema of the on-device sampler (`algo/sampling.py`:
time-major [T, N, ...], T+1 obs/rnn entries), so the same learner consumes it.
Where the JAX sampler assembles it at the end in one jitted program, this one
allocates the [T(+1), N, ...] tensors at the start of a rollout and writes each
slot's results into their slices as they are produced: the observations go from
the slab through one pinned staging buffer straight into their place in the
trajectory, and there is no assemble pass (nor a second copy of the frames).

Per (timestep, split) the device sees: the observations up, one policy step,
the actions down. Rewards, dones, time-outs and `active` stay in [T, N] numpy
buffers and go up once a rollout.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sample_factory_tpu_torch.algo.distributions import get_action_distribution, sample_actions_log_probs
from sample_factory_tpu_torch.algo.host_worker import (  # noqa: F401 - re-exported
    EnvSlotStepper,
    ShmSlabs,
    _convert_host_action,
    host_env_worker,
)
from sample_factory_tpu_torch.algo.sampling import normalize_obs
from sample_factory_tpu_torch.envs.spaces import action_dtype
from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state
from sample_factory_tpu_torch.utils.utils import log

WORKER_INIT_TIMEOUT_S = 300.0
SLOT_TIMERS = ("wait_workers", "upload", "policy_step", "action_fetch")


def _process_rewards_np(cfg, rewards: np.ndarray) -> np.ndarray:
    """Reward scale/clip (reference batched_sampling.py:208-214), in numpy: the hot loop
    never routes a tiny array through the device, where one eager op and its readback would
    make the host wait for everything queued there (learner quanta, the other split's step)."""
    return np.clip(rewards * cfg.reward_scale, -cfg.reward_clip, cfg.reward_clip)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class HostVectorSampler:
    """Steps W workers x K splits x E envs and produces trajectories on `device`.

    In --serial_mode the envs are stepped inline (no processes), the debugging
    fallback the reference also provides (docs/07-advanced-topics/serial-mode.md).
    Every draw of the policy comes from one generator on the sampler's device.
    """

    def __init__(self, cfg, env_info, device, register_fn=None):
        self.cfg = cfg
        self.env_info = env_info
        self.device = torch.device(device)
        self.register_fn = register_fn

        self.W = cfg.num_workers
        self.K = cfg.worker_num_splits
        if cfg.num_envs_per_worker % self.K:
            raise ValueError(f"num_envs_per_worker ({cfg.num_envs_per_worker}) must divide by worker_num_splits ({self.K})")
        self.A = env_info.num_agents
        self.E = (cfg.num_envs_per_worker // self.K) * self.A  # agent-slots per worker-split
        self.num_envs = self.W * self.K * self.E  # total agent-slots (transitions per step)
        self.split_size = self.W * self.E  # slots per split across all workers

        self.slabs = ShmSlabs(cfg, env_info, create=True)
        self.obs_keys = [k[4:] for k in self.slabs.arrays if k.startswith("obs_")]
        self.workers: List[mp.Process] = []
        self.cmd_conns: List[Any] = []
        self.res_conns: List[Any] = []
        self.serial_steppers: Optional[List[EnvSlotStepper]] = None
        self._use_shm_queue = False
        self.result_queue = None
        self._ready_counts: Dict[int, int] = {}
        self._closed = False

        self.a_dtype = torch.int32 if action_dtype(env_info.action_space) == "int32" else torch.float32
        # each rank of a data-parallel run draws its own actions: its runner offsets them as its envs' seeds
        seed = (cfg.seed if cfg.seed is not None else 0) + 1 + getattr(cfg, "env_seed_offset", 0)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # per-split policy state on the device
        self.rnn_states = [initial_actor_critic_state(cfg, self.split_size, self.device) for _ in range(self.K)]

        # On the card, one pinned staging tensor per split and obs key (and one for the done
        # mask): the slab is copied into it on the host (the one copy), and from it
        # asynchronously into the trajectory's slice. A staging tensor is reused every step;
        # `_staging_free[s]` is an event recorded after the copies that read it, waited for
        # before the host writes it again (normally long passed: the action fetch of the same
        # slot synchronises the stream; the final flush of a rollout has no fetch after it).
        self._pinned = self.device.type == "cuda"
        self._staging: List[Dict[str, torch.Tensor]] = []
        self._staging_done: List[torch.Tensor] = []
        self._staging_free: List[Any] = []
        if self._pinned:
            for _ in range(self.K):
                self._staging.append({
                    k: torch.empty((self.split_size,) + arr.shape[3:], dtype=_torch_dtype(arr.dtype)).pin_memory()
                    for k in self.obs_keys for arr in [self.slabs.arrays[f"obs_{k}"]]
                })
                self._staging_done.append(torch.zeros(self.split_size).pin_memory())
                self._staging_free.append(None)

        self._zero_done = np.zeros(self.split_size, np.float32)
        self._host_buf: Dict[str, np.ndarray] = {}
        self._traj: Dict[str, Any] = {}
        self.episodic: List[Tuple[float, int]] = []  # (processed_return, length)
        self.episodic_slots: List[int] = []  # the trajectory column (agent slot) of each entry of `episodic`
        self._raw_return_sum = 0.0  # pre-scale/clip returns of completed episodes
        self.episodic_extras: List[Dict[str, Any]] = []  # episode_extra_stats dicts
        # host-clock seconds spent per part of a (timestep, split) slot, and the slots counted
        self.slot_seconds = dict.fromkeys(SLOT_TIMERS, 0.0)
        self.slots_timed = 0

    # ------------------------------------------------------------- lifecycle

    @property
    def transport(self) -> str:
        if self.serial_steppers is not None:
            return "serial"
        return "shm_queue" if self._use_shm_queue else "pipes"

    def start(self, use_shm_queue: Optional[bool] = None) -> None:
        """Create the envs: inline in --serial_mode, else in W spawned worker processes.
        `use_shm_queue=False` forces the pipe transport (the fallback when the native queue
        cannot be built); None takes the native queue where it builds."""
        if self.cfg.serial_mode:
            self._start_serial()
            return
        ctx = mp.get_context("spawn")
        register_fn_pickled = pickle.dumps(self.register_fn) if self.register_fn is not None else None

        # prefer the native shm queue (batched get_many drains all worker
        # ready-signals under one lock, like the reference's faster-fifo)
        from sample_factory_tpu_torch.native.shm_queue import ShmQueue

        self._use_shm_queue = ShmQueue.available() if use_shm_queue is None else bool(use_shm_queue)
        if self._use_shm_queue:
            self.result_queue = ShmQueue(capacity_bytes=4 << 20)

        for w in range(self.W):
            if self._use_shm_queue:
                cmd_q = ShmQueue(capacity_bytes=1 << 20)
                child_cmd, child_res = cmd_q, self.result_queue
                self.cmd_conns.append(cmd_q)
                self.res_conns.append(None)
            else:
                parent_cmd, child_cmd = ctx.Pipe()
                parent_res, child_res = ctx.Pipe()
                self.cmd_conns.append(parent_cmd)
                self.res_conns.append(parent_res)
            p = ctx.Process(
                target=host_env_worker,
                args=(w, self.cfg, self.env_info, self.slabs.attach_spec(), child_cmd, child_res, register_fn_pickled),
                daemon=True,
            )
            p.start()
            self.workers.append(p)

        initialized = 0
        deadline = time.time() + WORKER_INIT_TIMEOUT_S
        while initialized < self.W:
            for w, msg in self._recv_results(timeout=min(1.0, max(0.0, deadline - time.time()))):
                if msg[0] == "error":
                    raise RuntimeError(f"worker {w} failed to init: {msg[2]}")
                assert msg[0] == "initialized"
                initialized += 1
            if initialized < self.W:
                self._raise_if_worker_died("while initializing")
            if time.time() > deadline:
                raise TimeoutError("host env workers did not initialize in time")
        log.info("HostVectorSampler: %d workers x %d splits x %d envs started (transport=%s)",
                 self.W, self.K, self.E, self.transport)

    def _recv_results(self, timeout: float) -> List[Tuple[int, tuple]]:
        """Drain available (worker, msg) results from all workers."""
        out: List[Tuple[int, tuple]] = []
        if self._use_shm_queue:
            from sample_factory_tpu_torch.native.shm_queue import QueueEmpty

            try:
                out.extend(self.result_queue.get_many(timeout=timeout))
            except QueueEmpty:
                pass
            return out
        deadline = time.time() + timeout
        for w in range(self.W):
            while self.res_conns[w].poll(0):
                out.append((w, self.res_conns[w].recv()))
        if not out:
            # block on the first conn that becomes readable
            for w in range(self.W):
                if self.res_conns[w].poll(max(0.0, deadline - time.time())):
                    out.append((w, self.res_conns[w].recv()))
                    break
        return out

    def _raise_if_worker_died(self, when: str) -> None:
        for w, p in enumerate(self.workers):
            if not p.is_alive():
                raise RuntimeError(f"worker {w} died {when} (exit code {p.exitcode})")

    def _start_serial(self) -> None:
        self.serial_steppers = []
        for w in range(self.W):
            stepper = EnvSlotStepper(self.cfg, self.env_info, self.slabs, w)
            stepper.create_envs()
            stepper.reset_all()
            self.serial_steppers.append(stepper)

    def _send(self, conn, msg) -> None:
        if self._use_shm_queue:
            conn.put(msg)
        else:
            conn.send(msg)

    def close(self) -> None:
        """Stop the workers, release queues and remove the shared-memory segments. Safe to
        call twice, and after a worker died."""
        if self._closed:
            return
        self._closed = True
        if self.serial_steppers is not None:
            for stepper in self.serial_steppers:
                stepper.close()
        else:
            for conn in self.cmd_conns:
                try:
                    self._send(conn, ("close",))
                except Exception:  # noqa: BLE001
                    pass
            for p in self.workers:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            if self._use_shm_queue:
                for q in self.cmd_conns:
                    q.close()
                if self.result_queue is not None:
                    self.result_queue.close()
            else:
                for conn in self.cmd_conns + self.res_conns:
                    conn.close()
        self.slabs.close(unlink=True)

    # ------------------------------------------------------------- stepping

    @torch.no_grad()
    def _policy_step(self, model, obs_rms, obs, rnn_in):
        """One policy's forward and action draw on `obs` -> (actions, log_probs, action_params,
        values, new_rnn). Step mode: no kernel runs here."""
        action_params, values, new_rnn = model(normalize_obs(self.cfg, obs_rms, obs), rnn_in)
        dist = get_action_distribution(self.env_info.action_space, action_params, obs.get("action_mask"))
        actions, log_probs = sample_actions_log_probs(dist, self.generator)
        return actions.to(self.a_dtype), log_probs, action_params, values, new_rnn

    @torch.no_grad()
    def _policy_step_multi(self, models, obs_rms, obs, rnn_in, groups):
        """Mixed-policy step: each policy's forward on its own slots, scattered back into slot
        order (as the on-device mixed rollout, `algo/sampling.py`). The JAX sampler runs all P
        forwards on every slot and selects; a slot's result depends on its own row only, so
        this is 1/P of the work for the same per-slot results. `groups`: [(p, slot indices)]."""
        merged = None
        for p, idx in groups:
            part_obs = {k: v.index_select(0, idx) for k, v in obs.items()}
            rms = None if obs_rms is None else obs_rms[p]
            outs = self._policy_step(models[p], rms, part_obs, rnn_in.index_select(0, idx))
            if merged is None:
                merged = [torch.empty((rnn_in.shape[0],) + tuple(o.shape[1:]), dtype=o.dtype, device=o.device) for o in outs]
            for full, part in zip(merged, outs):
                full.index_copy_(0, idx, part)
        return tuple(merged)

    def _slab_split(self, key: str, split: int) -> np.ndarray:
        """The [W, E, ...] view of one split of a slab (worker-major, not contiguous)."""
        return self.slabs.arrays[key][:, split]

    def _upload_obs(self, s: int, t: int) -> Dict[str, torch.Tensor]:
        """Copy split s's observations out of the slab into row t of the trajectory (the
        worker overwrites the slab at its next step) and return that row's views. On the
        card: slab -> pinned staging (host copy) -> trajectory slice (asynchronous copy)."""
        lo, hi = s * self.split_size, (s + 1) * self.split_size
        out = {}
        for k in self.obs_keys:
            dst = self._traj["obs"][k][t, lo:hi]
            src = self._slab_split(f"obs_{k}", s)
            if self._pinned:
                stage = self._staging[s][k]
                np.copyto(stage.numpy().reshape(src.shape), src)
                dst.copy_(stage, non_blocking=True)
            else:
                np.copyto(dst.numpy().reshape(src.shape), src)
            out[k] = dst
        return out

    def _upload_done(self, s: int, done: np.ndarray) -> torch.Tensor:
        if not self._pinned:
            return torch.from_numpy(done.copy())
        stage = self._staging_done[s]
        np.copyto(stage.numpy(), done)
        return stage.to(self.device, non_blocking=True)

    def _acquire_staging(self, s: int) -> None:
        """Before the host writes split s's staging tensors: wait for the copies that read them."""
        if self._pinned and self._staging_free[s] is not None:
            self._staging_free[s].synchronize()

    def _release_staging(self, s: int) -> None:
        if self._pinned:
            event = torch.cuda.Event()
            event.record()
            self._staging_free[s] = event

    def _reset_rnn(self, s: int, done: np.ndarray) -> torch.Tensor:
        """The split's rnn state with the rows of finished episodes zeroed. A feed-forward
        policy's state is all zeros and stays so: nothing goes up for it."""
        rnn = self.rnn_states[s]
        if not self.cfg.use_rnn or done is self._zero_done:
            return rnn
        done_dev = self._upload_done(s, done)
        return torch.where(done_dev[:, None] > 0, torch.zeros_like(rnn), rnn)

    def _signal_step(self, split: int) -> None:
        if self.serial_steppers is not None:
            for w, stepper in enumerate(self.serial_steppers):
                self._record_completed(w, split, stepper.step_split(split))
            return
        for conn in self.cmd_conns:
            self._send(conn, ("step", split))

    def _wait_ready(self, split: int) -> None:
        """Block until every worker has stepped `split`. A worker that reports an error, dies
        or stays silent past the heartbeat deadline raises here."""
        if self.serial_steppers is not None:
            return
        deadline = time.time() + max(10.0, self.cfg.heartbeat_reporting_interval)
        while self._ready_counts.get(split, 0) < self.W:
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(f"workers did not respond for split {split} (heartbeat timeout)")
            results = self._recv_results(timeout=min(remaining, 1.0))
            for w, msg in results:
                if msg[0] == "error":
                    raise RuntimeError(f"worker {w} crashed: {msg[2]}")
                if msg[0] != "ready":
                    continue
                self._ready_counts[msg[1]] = self._ready_counts.get(msg[1], 0) + 1
                self._record_completed(w, msg[1], msg[2])
            if not results:
                self._raise_if_worker_died(f"before answering for split {split}")
        self._ready_counts[split] -= self.W

    def _record_completed(self, w: int, split: int, completed) -> None:
        for r, raw_r, length, extras, slot in completed:
            self.episodic.append((r, length))
            self.episodic_slots.append(split * self.split_size + w * self.E + slot)
            self._raw_return_sum += raw_r
            if extras:
                self.episodic_extras.append(extras)

    def set_reward_shaping(self, shaping: Dict[str, Any], slot_mask=None) -> None:
        """Push PBT-mutated reward shaping to the envs. slot_mask
        [K, split_size] (slots are worker-major) selects affected agents."""
        per_worker = self.E  # slots per worker-split
        for w in range(self.W):
            mask_w = None if slot_mask is None else np.asarray(slot_mask)[:, w * per_worker : (w + 1) * per_worker]
            if self.serial_steppers is not None:
                self.serial_steppers[w].set_reward_shaping(shaping, mask_w)
            else:
                self._send(self.cmd_conns[w], ("set_reward_shaping", shaping, mask_w))

    # ------------------------------------------------------ rollout assembly

    def collect_rollout(self, model, obs_rms, policy_version, policy_id: int = 0, slot_policies=None, idle_fn=None):
        """Collect cfg.rollout steps from all envs. Returns (trajectory, stats).

        Per timestep, splits are processed round-robin: while split s's envs
        step on CPU workers, the device runs inference for split s+1.

        idle_fn, if given, is called once per (timestep, split) right after
        that split's actions are shipped to the workers: a slot in which the
        device has nothing to do for the rollout, which the runner uses to
        dispatch learner quanta (QuantizedTrainer).

        Multi-policy self-play: pass lists of P models and obs_rms (or None),
        slot_policies [K, split_size] (agent->policy mapping, a host array) and
        policy_version as P ints.
        """
        T, N = self.cfg.rollout, self.num_envs
        self.episodic, self.episodic_slots, self.episodic_extras = [], [], []
        self._raw_return_sum = 0.0
        # host-side scalar streams live in preallocated numpy buffers laid out [T, N] (env
        # axis split-major, as the trajectory) and go up once, at the end of the rollout
        self._host_buf = {k: np.zeros((T, N), np.float32) for k in ("rewards", "dones", "time_outs", "active")}
        self._traj = {"obs": {
            k: torch.empty((T + 1, N) + arr.shape[3:], dtype=_torch_dtype(arr.dtype), device=self.device)
            for k in self.obs_keys for arr in [self.slabs.arrays[f"obs_{k}"]]
        }}
        groups = None
        if slot_policies is not None:
            slot_policies = np.asarray(slot_policies)
            groups = [
                [(p, torch.as_tensor(rows, device=self.device)) for p in range(len(model))
                 if len(rows := np.nonzero(slot_policies[s] == p)[0])]
                for s in range(self.K)
            ]

        for t in range(T):
            for s in range(self.K):
                self._collect_one(model, obs_rms, t, s, None if groups is None else groups[s])
                if idle_fn is not None:
                    idle_fn()

        # flush: wait for the last env steps, finalize rewards/dones, reset on the last done
        for s in range(self.K):
            self._wait_ready(s)
            done = self._finalize_last(s, T - 1)
            self._acquire_staging(s)
            self.rnn_states[s] = self._reset_rnn(s, done)
            self._upload_obs(s, T)
            self._release_staging(s)
            self._traj["rnn_states"][T, s * self.split_size : (s + 1) * self.split_size] = self.rnn_states[s]

        traj = self._finish_trajectory(policy_version, policy_id, slot_policies)
        stats = {
            "count": float(len(self.episodic)),
            "return_sum": float(sum(r for r, _ in self.episodic)),
            "raw_return_sum": float(self._raw_return_sum),
            "len_sum": float(sum(n for _, n in self.episodic)),
            "extra_stats": list(self.episodic_extras),
            # each completed episode as (processed return, length), and the trajectory column
            # (agent slot) it ended in
            "episodes": list(self.episodic),
            "slots": list(self.episodic_slots),
        }
        return traj, stats

    def _collect_one(self, model, obs_rms, t: int, s: int, groups) -> None:
        clock = time.perf_counter
        t0 = clock()
        if t > 0:
            # finalize previous step's transition for this split
            self._wait_ready(s)
            done = self._finalize_last(s, t - 1)
        else:
            done = self._zero_done
        t1 = clock()

        self._acquire_staging(s)
        obs = self._upload_obs(s, t)
        rnn_in = self._reset_rnn(s, done)  # the post-reset state the step consumes
        self._release_staging(s)
        t2 = clock()
        if groups is None:
            outs = self._policy_step(model, obs_rms, obs, rnn_in)
        else:
            outs = self._policy_step_multi(model, obs_rms, obs, rnn_in, groups)
        actions, log_probs, action_params, values, new_rnn = outs
        self.rnn_states[s] = new_rnn
        t3 = clock()

        # ship actions to workers and let them step while we do other splits; the fetch
        # waits for the device, so the staging buffers of this slot are free after it
        a_np = actions.cpu().numpy()
        self.slabs.arrays["actions"][:, s] = a_np.reshape((self.W, self.E) + a_np.shape[1:])
        self._signal_step(s)
        t4 = clock()

        lo, hi = s * self.split_size, (s + 1) * self.split_size
        step = {"rnn_states": rnn_in, "actions": actions, "action_logits": action_params,
                "log_prob_actions": log_probs, "values": values}
        if t == 0 and s == 0:
            T, N = self.cfg.rollout, self.num_envs
            for k, v in step.items():
                rows = T + 1 if k == "rnn_states" else T
                self._traj[k] = torch.empty((rows, N) + tuple(v.shape[1:]), dtype=v.dtype, device=self.device)
        for k, v in step.items():
            self._traj[k][t, lo:hi] = v

        sec = self.slot_seconds
        sec["wait_workers"] += t1 - t0
        sec["upload"] += t2 - t1
        sec["policy_step"] += t3 - t2
        sec["action_fetch"] += t4 - t3
        self.slots_timed += 1

    def _finalize_last(self, s: int, t: int) -> np.ndarray:
        """Read the step-t results for split s from the slabs into the host
        buffers. Returns the done mask (float32 [split_size])."""
        rew = self._slab_split("rewards", s).reshape(self.split_size)
        term = self._slab_split("terminated", s).reshape(self.split_size)
        trunc = self._slab_split("truncated", s).reshape(self.split_size)
        active = self._slab_split("active", s).reshape(self.split_size)
        done = np.logical_or(term, trunc).astype(np.float32)
        lo, hi = s * self.split_size, (s + 1) * self.split_size
        buf = self._host_buf
        buf["rewards"][t, lo:hi] = _process_rewards_np(self.cfg, rew.astype(np.float32))
        buf["dones"][t, lo:hi] = done
        buf["time_outs"][t, lo:hi] = np.logical_and(trunc, ~term)
        buf["active"][t, lo:hi] = active
        return done

    def _finish_trajectory(self, policy_version, policy_id, slot_policies) -> Dict[str, Any]:
        """The rollout's tensors plus the host-side streams, uploaded as six [T, N] arrays:
        rewards, dones, time_outs, policy_id, policy_version (and `active` folded into
        policy_id: inactive agents get -1 and are masked by the learner's valids, reference
        non_batched_sampling.py is_active)."""
        traj, buf = self._traj, self._host_buf
        self._traj, self._host_buf = {}, {}
        shape = buf["rewards"].shape
        if slot_policies is None:
            pid = np.full(shape, policy_id, np.int32)
            version = np.full(shape, int(policy_version), np.int32)
        else:
            # per-slot policy assignment; versions indexed by the slot's policy
            slot_pol = np.concatenate([slot_policies[s] for s in range(self.K)]).astype(np.int32)
            pid = np.broadcast_to(slot_pol[None, :], shape)
            version = np.broadcast_to(np.asarray(policy_version, np.int32)[slot_pol][None, :], shape)
        host = {"rewards": buf["rewards"], "dones": buf["dones"], "time_outs": buf["time_outs"],
                "policy_id": np.where(buf["active"] > 0, pid, -1).astype(np.int32),
                "policy_version": np.ascontiguousarray(version)}
        for k, v in host.items():
            traj[k] = torch.from_numpy(v).to(self.device)  # fresh arrays each rollout: nothing aliases them
        return traj
