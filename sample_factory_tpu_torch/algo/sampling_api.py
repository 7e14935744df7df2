"""Library-style sampling APIs: collect trajectories without a learner.

Counterpart of `sample_factory_tpu/algo/sampling_api.py` (reference
`sample_factory/algo/sampling/sync_sampling_api.py:16`,
SyncSamplingAPI.get_trajectories_sync, and `evaluation_sampling_api.py:31,234`).
One class serves on-device envs (`algo/sampling.py`) and host envs
(`algo/host_sampling.py`, `HostVectorSampler`); the trajectory is the port's
standard time-major [T, N, ...] dict either way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from sample_factory_tpu_torch.algo.learning import PolicyTrainState, init_train_state
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, make_rollout_fn
from sample_factory_tpu_torch.envs.env_info import EnvInfo, obtain_env_info
from sample_factory_tpu_torch.envs.env_utils import create_env
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.utils.utils import resolve_device


class SyncSamplingAPI:
    """Blocking trajectory collection with the current (or checkpointed) policy."""

    def __init__(self, cfg, env_info: Optional[EnvInfo] = None, register_fn: Optional[Callable] = None,
                 load_from_checkpoint: bool = False):
        self.cfg = cfg
        self.register_fn = register_fn
        self.env_info = env_info or obtain_env_info(cfg, register_fn=register_fn)
        self.seed = cfg.seed if cfg.seed is not None else 0
        self.device = resolve_device(cfg)

        self._device_env = None
        self._host_sampler = None
        self._rollout_fn = None
        self._sampler_state = None
        self.train_state: Optional[PolicyTrainState] = None
        self._load_ckpt = load_from_checkpoint
        self._last_ep_stats: Dict[str, float] = {}
        self.episodic: List[Tuple[float, int]] = []

    def start(self, train_state: Optional[PolicyTrainState] = None) -> None:
        cfg = self.cfg
        if self.env_info.is_device_env:
            self._device_env = create_env(cfg.env, cfg=cfg, env_config=None)
            generator = torch.Generator(self.device).manual_seed(self.seed + 1)
            self._sampler_state = init_sampler_state(cfg, self._device_env, cfg.num_envs, self.device, generator)
            self._rollout_fn = make_rollout_fn(cfg, self._device_env, self.env_info)
        else:
            from sample_factory_tpu_torch.algo.host_sampling import HostVectorSampler

            self._host_sampler = HostVectorSampler(cfg, self.env_info, self.device, register_fn=self.register_fn)
            cfg.num_envs = self._host_sampler.num_envs
            try:
                self._host_sampler.start()
            except BaseException:
                self._host_sampler.close()
                raise

        if train_state is not None:
            self.train_state = train_state
            return
        model = create_actor_critic(cfg, self.env_info.obs_space, self.env_info.action_space, torch.Generator().manual_seed(self.seed))
        self.train_state = init_train_state(cfg, self.env_info, model.to(self.device), self.device)
        if self._load_ckpt:
            load_checkpoint(cfg, cfg.policy_index, self.train_state)

    def set_train_state(self, train_state: PolicyTrainState) -> None:
        """The analog of the reference's parameter-server weight update."""
        self.train_state = train_state

    def get_trajectories_sync(self) -> Dict[str, Any]:
        """Collect one rollout's worth of trajectories from all envs."""
        ts = self.train_state
        if self._host_sampler is not None:
            traj, stats = self._host_sampler.collect_rollout(ts.model, ts.obs_rms, ts.train_step, int(self.cfg.policy_index))
            self.episodic.extend(stats["episodes"])
            self._last_ep_stats = stats
            return traj
        self._sampler_state, traj, ep_stats = self._rollout_fn(
            ts.model, ts.obs_rms, self._sampler_state, ts.train_step, int(self.cfg.policy_index)
        )
        self._last_ep_stats = {k: float(v) for k, v in ep_stats.items()}
        return traj

    def stop(self) -> None:
        """Stop a host sampler's workers; on-device envs hold no process or file."""
        if self._host_sampler is not None:
            self._host_sampler.close()


class EvalSamplingAPI(SyncSamplingAPI):
    """Evaluation sampler: loads the checkpoint and accumulates episode stats."""

    def __init__(self, cfg, env_info: Optional[EnvInfo] = None, register_fn: Optional[Callable] = None):
        super().__init__(cfg, env_info, register_fn, load_from_checkpoint=True)

    def sample_episodes(self, num_episodes: int) -> List[Tuple[float, int]]:
        """At least `num_episodes` (return, length) pairs. A host sampler reports every episode;
        on the device path the episodes a rollout completed enter as that many copies of their
        average, as the aggregate stats give no more."""
        episodes: List[Tuple[float, int]] = []
        while len(episodes) < num_episodes:
            self.get_trajectories_sync()
            if self._host_sampler is not None:
                episodes = list(self.episodic)
                continue
            stats = self._last_ep_stats
            n = int(stats["count"])
            if n:
                episodes.extend([(stats["return_sum"] / n, int(stats["len_sum"] / n))] * n)
        self.episodic = episodes[:num_episodes]
        return self.episodic
