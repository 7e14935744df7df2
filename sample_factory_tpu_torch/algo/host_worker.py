"""The worker half of the host-env sampler: numpy only.

Counterpart of `sample_factory_tpu/algo/host_sampling.py:55-498` (`ShmSlabs`,
`_convert_host_action`, `EnvSlotStepper`, `host_env_worker`), the replacement of
the reference's RolloutWorker processes and shared-memory trajectory buffers
(reference `algo/sampling/rollout_worker.py`, `algo/utils/shared_buffers.py`).
Worker processes step envs and exchange data with the main process through
preallocated SharedMemory slabs; only small control messages cross the queue
or pipe.

This module and everything it imports stay free of torch (and of gymnasium,
unless the env needs it): workers are spawned, the child re-imports what the
target function's module imports, and a torch import would cost every worker
seconds and memory for nothing. `algo/host_sampling.py` holds the main-process
half and re-exports these names.
"""

from __future__ import annotations

import os
import pickle
import time
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sample_factory_tpu_torch.envs.spaces import Discrete, action_dtype, num_actions, obs_space_as_dict
from sample_factory_tpu_torch.utils.attr_dict import AttrDict
from sample_factory_tpu_torch.utils.utils import log

WORKER_COMMAND_TIMEOUT_S = 3600.0

# ------------------------------------------------------------------ shm slabs


class ShmSlabs:
    """Preallocated shared-memory arrays for worker<->main data exchange.

    Layout: per array, [num_workers, num_splits, envs_per_split, ...].
    """

    def __init__(self, cfg, env_info, create: bool = True, name_prefix: Optional[str] = None):
        self.cfg = cfg
        W = cfg.num_workers
        K = cfg.worker_num_splits
        A = env_info.num_agents
        E = (cfg.num_envs_per_worker // K) * A  # agent-slots per split
        self.shape_prefix = (W, K, E)

        obs_spec = obs_space_as_dict(env_info.obs_space)
        self._specs: Dict[str, Tuple[tuple, np.dtype]] = {}
        for key, space in obs_spec.items():
            self._specs[f"obs_{key}"] = (self.shape_prefix + tuple(space.shape), np.dtype(getattr(space, "dtype", "float32")))
        a_dt = np.int32 if action_dtype(env_info.action_space) == "int32" else np.float32
        self._specs["actions"] = (self.shape_prefix + (num_actions(env_info.action_space),), np.dtype(a_dt))
        self._specs["rewards"] = (self.shape_prefix, np.dtype(np.float32))
        self._specs["terminated"] = (self.shape_prefix, np.dtype(np.bool_))
        self._specs["truncated"] = (self.shape_prefix, np.dtype(np.bool_))
        # multi-agent: inactive agents are masked out of training
        # (reference non_batched_sampling.py:82-84 is_active handling)
        self._specs["active"] = (self.shape_prefix, np.dtype(np.bool_))

        self._prefix = name_prefix or f"sftpu_{os.getpid()}_{int(time.time() * 1e6) % 10**9}"
        self._shms: Dict[str, shared_memory.SharedMemory] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        for name, (shape, dtype) in self._specs.items():
            nbytes = int(np.prod(shape)) * dtype.itemsize
            shm_name = f"{self._prefix}_{name}"
            if create:
                shm = shared_memory.SharedMemory(name=shm_name, create=True, size=max(1, nbytes))
            else:
                shm = shared_memory.SharedMemory(name=shm_name, create=False)
            self._shms[name] = shm
            self.arrays[name] = np.ndarray(shape, dtype=dtype, buffer=shm.buf)
            if create:
                self.arrays[name].fill(0)

    def attach_spec(self):
        return {"prefix": self._prefix, "specs": self._specs}

    @classmethod
    def attach(cls, cfg, env_info, spec):
        obj = cls.__new__(cls)
        obj.cfg = cfg
        obj._prefix = spec["prefix"]
        obj._specs = spec["specs"]
        obj._shms = {}
        obj.arrays = {}
        for name, (shape, dtype) in obj._specs.items():
            shm = shared_memory.SharedMemory(name=f"{obj._prefix}_{name}", create=False)
            obj._shms[name] = shm
            obj.arrays[name] = np.ndarray(shape, dtype=dtype, buffer=shm.buf)
        return obj

    def close(self, unlink: bool = False):
        """Drop the views, unmap, and (the creating side) remove the segments. A view that is
        still referenced elsewhere keeps its mapping alive (`close` then raises BufferError);
        the segment's name is removed all the same, so nothing stays behind in /dev/shm."""
        self.arrays.clear()
        for shm in self._shms.values():
            try:
                shm.close()
            except BufferError:
                pass
            if unlink:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
        self._shms.clear()


# ------------------------------------------------------------------- worker


def _convert_host_action(space, a: np.ndarray):
    """Flat action vector -> what the env expects (int for Discrete, array for Box, tuple of
    components for Tuple; reference batched_sampling.py preprocess_actions). `space` is a
    gymnasium space or one of the port's specs: both name their classes alike, so the class
    name decides and gymnasium is not imported."""
    kind = type(space).__name__
    if kind == "Discrete":
        return int(a[0]) if getattr(a, "ndim", 0) else int(a)
    if kind == "Box":
        return np.asarray(a, dtype=space.dtype).reshape(space.shape)
    if kind in ("Tuple", "TupleSpec"):
        parts, off = [], 0
        for sub in space.spaces:
            n = 1 if type(sub).__name__ == "Discrete" else int(np.prod(sub.shape))
            parts.append(_convert_host_action(sub, a[off : off + n]))
            off += n
        return tuple(parts)
    # fallback: squeeze single-component int actions, pass arrays through
    if a.shape and a.shape[0] == 1 and np.issubdtype(a.dtype, np.integer):
        return int(a[0])
    return a


def _random_action(space, rng: np.random.Generator):
    """A uniform random action: gymnasium's `sample()`, or drawn from `rng` for the port's specs
    (which have no sampler; an unbounded Box side is taken as 1 in size)."""
    if hasattr(space, "sample"):
        return space.sample()
    kind = type(space).__name__
    if kind == "Discrete":
        return int(rng.integers(space.n))
    if kind == "TupleSpec":
        return tuple(_random_action(sub, rng) for sub in space.spaces)
    if kind == "Box":
        low = space.low if np.isfinite(space.low) else -1.0
        high = space.high if np.isfinite(space.high) else 1.0
        return rng.uniform(low, high, space.shape).astype(space.dtype)
    raise NotImplementedError(f"no random action for {space!r}")


class EnvSlotStepper:
    """Owns one worker's envs and maps them onto agent-slots in the slabs.

    Single-agent envs occupy one slot each; multi-agent envs (reference
    convention: env.num_agents > 1, step(list) -> lists, infos carry
    'is_active') occupy num_agents consecutive slots. Inactive agents are
    recorded in the 'active' slab so the learner masks them
    (reference non_batched_sampling.py:82-84,197-203).

    Batched vector envs (is_batched_vector_env=True: one object stepping a
    whole batch as arrays — the reference's BatchedVecEnv contract,
    batched_sampling.py:298-392, and the envpool backend) get ONE instance
    per split sized to the split (env_config.num_envs) and are stepped with
    a single array call, no per-env Python loop. The contract is auto-reset:
    obs returned for done envs is the next episode's first observation.
    """

    def __init__(self, cfg, env_info, slabs: "ShmSlabs", worker_idx: int):
        self.cfg = cfg
        self.env_info = env_info
        self.slabs = slabs
        self.w = worker_idx
        self.seed = cfg.seed or 0
        self.K = cfg.worker_num_splits
        self.A = env_info.num_agents
        self.E = cfg.num_envs_per_worker // self.K  # envs per split
        self.multiagent = self.A > 1
        self.batched = False  # set by create_envs when the factory returns a batched vector env
        self._squeeze_actions = False
        self.envs: List[List[Any]] = []
        slots = self.E * self.A
        # processed (scaled/clipped, what the learner sees) and raw returns are
        # tracked separately (reference batched_sampling.py episodic stats keep
        # both; device sampler: sampling.py ep_return vs ep_return_raw)
        self.ep_returns = np.zeros((self.K, slots), np.float64)
        self.ep_raw_returns = np.zeros((self.K, slots), np.float64)
        self.ep_lens = np.zeros((self.K, slots), np.int64)
        self._r_scale = float(cfg.reward_scale)
        self._r_clip = float(cfg.reward_clip)
        self.obs_keys = [k for k in slabs.arrays if k.startswith("obs_")]

    def _proc_reward(self, r: float) -> float:
        return float(np.clip(r * self._r_scale, -self._r_clip, self._r_clip))

    def create_envs(self) -> None:
        from sample_factory_tpu_torch.envs.env_utils import create_env

        for s in range(self.K):
            row = []
            for e in range(self.E):
                env_id = self.w * self.cfg.num_envs_per_worker + s * self.E + e
                # num_envs tells batched factories (envpool etc.) the split
                # size; per-env factories ignore it
                env_config = AttrDict(
                    worker_index=self.w, vector_index=s * self.E + e, env_id=env_id, num_envs=self.E
                )
                env = create_env(self.cfg.env, cfg=self.cfg, env_config=env_config)
                if getattr(env, "is_batched_vector_env", False):
                    if e != 0:
                        raise ValueError("a batched vector env must be the only env of its split")
                    if self.multiagent:
                        raise ValueError("batched + multi-agent host envs are not supported")
                    n = getattr(env, "num_envs", None)
                    if n != self.E:
                        raise ValueError(f"batched env has num_envs={n}, expected {self.E} (num_envs_per_worker/worker_num_splits)")
                    self.batched = True
                    self._squeeze_actions = isinstance(self.env_info.action_space, Discrete)
                    row.append(env)
                    break
                if not getattr(env, "is_multiagent", False):
                    from sample_factory_tpu_torch.envs.gym_wrappers import wrap_host_env  # needs gymnasium

                    env = wrap_host_env(env, self.cfg)
                row.append(env)
            self.envs.append(row)

    def _write_obs(self, s: int, slot: int, obs: Dict[str, np.ndarray]) -> None:
        for k in self.obs_keys:
            self.slabs.arrays[k][self.w, s, slot] = obs[k[4:]]

    def _wrap_ma_obs(self, obs):
        # multi-agent envs return raw per-agent obs (dict or array)
        return obs if isinstance(obs, dict) else {"obs": obs}

    def _write_obs_batch(self, s: int, obs_batch) -> None:
        ob = obs_batch if isinstance(obs_batch, dict) else {"obs": obs_batch}
        for k in self.obs_keys:
            self.slabs.arrays[k][self.w, s, :] = ob[k[4:]]

    def reset_all(self) -> None:
        if self.batched:
            self.slabs.arrays["active"][self.w] = True
            for s in range(self.K):
                obs, _ = self.envs[s][0].reset(seed=self.seed + self.w * 10007 + s * 101)
                self._write_obs_batch(s, obs)
            return
        self.slabs.arrays["active"][self.w] = True
        rng = np.random.default_rng(self.seed + self.w)
        total_envs = self.K * self.E
        for s in range(self.K):
            for e in range(self.E):
                seed = self.seed + self.w * 10007 + s * 101 + e
                if self.multiagent:
                    obs_list, _ = self.envs[s][e].reset(seed=seed)
                    for a in range(self.A):
                        self._write_obs(s, e * self.A + a, self._wrap_ma_obs(obs_list[a]))
                else:
                    obs, _ = self.envs[s][e].reset(seed=seed)
                    # stagger episode phases so resets don't synchronize across
                    # the vector (reference --decorrelate_envs_on_one_worker)
                    if self.cfg.decorrelate_envs_on_one_worker and not self.cfg.benchmark:
                        env = self.envs[s][e]
                        warmup = int(rng.integers(0, max(1, self.cfg.rollout * (s * self.E + e + 1) // total_envs + 1)))
                        for _ in range(warmup):
                            obs2, _, term, trunc, _ = env.step(_random_action(env.action_space, rng))
                            if term or trunc:
                                obs2, _ = env.reset()
                            obs = obs2
                    self._write_obs(s, e, obs)

    def step_split(self, split: int) -> List[Tuple[float, float, int, Optional[Dict[str, Any]], int]]:
        """Step all envs of a split using the actions slab; returns completed
        episodes as (return, raw_return, length, episode_extra_stats-or-None, slot)
        tuples. `slot` is the agent slot within this worker's split (the JAX
        package's tuples lack it): the multi-policy runner credits an episode to
        the policy that drove its slot.

        `episode_extra_stats` is the reference's per-episode custom-summaries
        channel (env info dict key, e.g. DMLab raw scores in
        sf_examples/dmlab/wrappers/reward_shaping.py:32-38); it rides the
        completed-episode message back to the runner's stats handlers."""
        if self.batched:
            return self._step_split_batched(split)
        arrays = self.slabs.arrays
        actions = arrays["actions"][self.w, split]
        completed: List[Tuple[float, float, int, Optional[Dict[str, Any]], int]] = []
        for e in range(self.E):
            env = self.envs[split][e]
            if self.multiagent:
                space = self.envs[split][e].action_space
                acts = [_convert_host_action(space, actions[e * self.A + a]) for a in range(self.A)]
                obs_list, rewards, terms, truncs, infos = env.step(acts)
                all_done = all(bool(t) or bool(tr) for t, tr in zip(terms, truncs))
                for a in range(self.A):
                    slot = e * self.A + a
                    self.ep_returns[split, slot] += self._proc_reward(rewards[a])
                    self.ep_raw_returns[split, slot] += rewards[a]
                    self.ep_lens[split, slot] += 1
                    arrays["rewards"][self.w, split, slot] = rewards[a]
                    arrays["terminated"][self.w, split, slot] = terms[a]
                    arrays["truncated"][self.w, split, slot] = truncs[a]
                    arrays["active"][self.w, split, slot] = infos[a].get("is_active", True)
                if all_done:
                    for a in range(self.A):
                        slot = e * self.A + a
                        extras = infos[a].get("episode_extra_stats") if isinstance(infos[a], dict) else None
                        completed.append(
                            (
                                float(self.ep_returns[split, slot]),
                                float(self.ep_raw_returns[split, slot]),
                                int(self.ep_lens[split, slot]),
                                extras,
                                slot,
                            )
                        )
                        self.ep_returns[split, slot] = 0.0
                        self.ep_raw_returns[split, slot] = 0.0
                        self.ep_lens[split, slot] = 0
                    obs_list, _ = env.reset()
                for a in range(self.A):
                    self._write_obs(split, e * self.A + a, self._wrap_ma_obs(obs_list[a]))
            else:
                a = _convert_host_action(env.action_space, actions[e])
                obs, reward, terminated, truncated, info = env.step(a)
                self.ep_returns[split, e] += self._proc_reward(reward)
                self.ep_raw_returns[split, e] += reward
                self.ep_lens[split, e] += 1
                if terminated or truncated:
                    extras = info.get("episode_extra_stats") if isinstance(info, dict) else None
                    completed.append(
                        (
                            float(self.ep_returns[split, e]),
                            float(self.ep_raw_returns[split, e]),
                            int(self.ep_lens[split, e]),
                            extras,
                            e,
                        )
                    )
                    self.ep_returns[split, e] = 0.0
                    self.ep_raw_returns[split, e] = 0.0
                    self.ep_lens[split, e] = 0
                    obs, _ = env.reset()
                arrays["rewards"][self.w, split, e] = reward
                arrays["terminated"][self.w, split, e] = terminated
                arrays["truncated"][self.w, split, e] = truncated
                self._write_obs(split, e, obs)
        return completed

    def _step_split_batched(self, split: int):
        """One array-call step of the whole split (reference
        batched_sampling.py:298-392): actions out of the slab, obs/rewards/
        dones written back as batches, episodic stats maintained vectorized."""
        arrays = self.slabs.arrays
        env = self.envs[split][0]
        acts = arrays["actions"][self.w, split]
        a = acts[:, 0] if self._squeeze_actions else acts
        obs, rew, term, trunc, infos = env.step(a)
        rew = np.asarray(rew, np.float32)
        term = np.asarray(term, bool)
        trunc = np.asarray(trunc, bool)
        arrays["rewards"][self.w, split] = rew
        arrays["terminated"][self.w, split] = term
        arrays["truncated"][self.w, split] = trunc

        proc = np.clip(rew * self._r_scale, -self._r_clip, self._r_clip)
        self.ep_returns[split] += proc
        self.ep_raw_returns[split] += rew
        self.ep_lens[split] += 1
        done = term | trunc
        completed: List[Tuple[float, float, int, Optional[Dict[str, Any]], int]] = []
        if done.any():
            extras_list = infos.get("episode_extra_stats") if isinstance(infos, dict) else None
            for i in np.nonzero(done)[0]:
                extras = None
                if extras_list is not None:
                    cand = extras_list[i]
                    extras = cand if isinstance(cand, dict) and cand else None
                completed.append(
                    (
                        float(self.ep_returns[split, i]),
                        float(self.ep_raw_returns[split, i]),
                        int(self.ep_lens[split, i]),
                        extras,
                        int(i),
                    )
                )
            self.ep_returns[split, done] = 0.0
            self.ep_raw_returns[split, done] = 0.0
            self.ep_lens[split, done] = 0
        self._write_obs_batch(split, obs)
        return completed

    def set_reward_shaping(self, shaping: Dict[str, Any], slot_mask: Optional[np.ndarray] = None) -> None:
        """Apply new reward shaping to envs. slot_mask [K, E*A] selects which
        agent slots (i.e. which policy's agents) it applies to; None = all.
        Batched vector envs get one whole-split call (per-slot granularity is
        a per-env-object feature)."""
        if self.batched:
            for s in range(self.K):
                env = self.envs[s][0]
                if hasattr(env, "set_reward_shaping") and (slot_mask is None or slot_mask[s].any()):
                    if slot_mask is not None and not slot_mask[s].all():
                        # a batched pool applies shaping to the whole split —
                        # with multi-policy PBT one policy's shaping would leak
                        # to another policy's envs; surface it loudly
                        log.warning(
                            "set_reward_shaping on a batched vector env covers the whole split "
                            "but slot_mask selects only %d/%d slots (split %d): shaping leaks to "
                            "other policies' envs. Use per-env (non-batched) envs for "
                            "multi-policy reward-shaping PBT.",
                            int(slot_mask[s].sum()),
                            slot_mask[s].size,
                            s,
                        )
                    try:
                        env.set_reward_shaping(shaping, 0)
                    except Exception as exc:  # noqa: BLE001
                        log.warning("set_reward_shaping failed on batched env (split %d): %s", s, exc)
            return
        for s in range(self.K):
            for e in range(self.E):
                env = self.envs[s][e]
                if not hasattr(env, "set_reward_shaping"):
                    continue
                for a in range(self.A):
                    slot = e * self.A + a
                    if slot_mask is None or slot_mask[s, slot]:
                        try:
                            env.set_reward_shaping(shaping, a)
                        except Exception as exc:  # noqa: BLE001 - env may not support per-agent
                            log.debug("set_reward_shaping failed (split %d env %d agent %d): %s", s, e, a, exc)

    def close(self) -> None:
        for row in self.envs:
            for env in row:
                try:
                    env.close()
                except Exception:  # noqa: BLE001
                    pass


def _apply_cpu_affinity(cfg, worker_idx: int) -> None:
    """Pin the worker to a core range (reference utils.py:471-500)."""
    if not cfg.set_workers_cpu_affinity:
        return
    try:
        cores = os.sched_getaffinity(0)
        num_cores = len(cores)
        core_list = sorted(cores)
        core = core_list[worker_idx % num_cores]
        os.sched_setaffinity(0, {core})
    except Exception:  # noqa: BLE001 - affinity is best-effort
        pass


def host_env_worker(worker_idx: int, cfg, env_info, slabs_spec, cmd_conn, res_conn, register_fn_pickled):
    """Worker process: owns num_envs_per_worker gymnasium envs split into
    worker_num_splits groups; steps a group per command.

    cmd_conn/res_conn are either mp.Pipe connections or ShmQueue instances
    (the native faster-fifo-equivalent channel): both expose recv/send via
    the small adapters below. Nothing here touches torch or the card.
    """
    recv_cmd = (lambda: cmd_conn.get(timeout=WORKER_COMMAND_TIMEOUT_S)) if hasattr(cmd_conn, "get") else cmd_conn.recv
    send_res = (
        (lambda msg: res_conn.put((worker_idx, msg))) if hasattr(res_conn, "put") else (lambda msg: res_conn.send(msg))
    )
    try:
        _apply_cpu_affinity(cfg, worker_idx)
        if cfg.force_envs_single_thread:
            os.environ.setdefault("OMP_NUM_THREADS", "1")
            os.environ.setdefault("MKL_NUM_THREADS", "1")

        # re-register envs in this process (the registry is per-process state)
        if register_fn_pickled is not None:
            register_fn = pickle.loads(register_fn_pickled)
            register_fn()

        slabs = ShmSlabs.attach(cfg, env_info, slabs_spec)
        stepper = EnvSlotStepper(cfg, env_info, slabs, worker_idx)
        stepper.create_envs()
        stepper.reset_all()
        send_res(("initialized", None, None))

        while True:
            msg = recv_cmd()
            if msg[0] == "step":
                split = msg[1]
                completed = stepper.step_split(split)
                send_res(("ready", split, completed))
            elif msg[0] == "set_reward_shaping":
                # PBT-mutated reward shaping for envs whose agents belong to a
                # policy (reference runner.py:425-451 update_training_info)
                stepper.set_reward_shaping(msg[1], msg[2])
            elif msg[0] == "close":
                break
        stepper.close()
        slabs.close()
        send_res(("closed", None, None))
    except KeyboardInterrupt:
        pass
    except Exception as e:  # noqa: BLE001
        import traceback

        send_res(("error", None, f"{e}\n{traceback.format_exc()}"))

