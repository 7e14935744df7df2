"""On-device sampler: policy forward, action sample and batched env step, T times.

Counterpart of `sample_factory_tpu/algo/sampling.py:33-326`. The JAX
package fuses the rollout into one `lax.scan` program; here it is a Python loop
over `cfg.rollout` steps, each a few batched torch ops on the env's device. The
trajectory schema is the same (reference `algo/utils/shared_buffers.py:67-92`):
time-major [T, N, ...] tensors with the keys of `TRAJECTORY_KEYS`, obs and
rnn_states with T+1 entries for the bootstrap value, and the rnn state reset
to zero where an episode ended.

Multi-agent envs go through the mixed-policy rollout (:159-302): the agents of
all envs are flattened into policy slots (env-major, `env * A + agent`), each
slot is driven by the policy assigned to it, and the episodic sums come back
per policy. The JAX version runs every policy's forward on every slot and
selects; each slot's output depends on its own row only, so here each policy
runs on its own slots and the results are scattered back into slot order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from sample_factory_tpu_torch.algo.distributions import get_action_distribution, sample_actions_log_probs
from sample_factory_tpu_torch.algo.running_mean_std import obs_rms_normalize
from sample_factory_tpu_torch.envs.device_env import DeviceEnv, autoreset_step, autoreset_step_ma
from sample_factory_tpu_torch.envs.spaces import action_dtype
from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state

TRAJECTORY_KEYS = (
    "obs", "rnn_states", "actions", "action_logits", "log_prob_actions", "values",
    "rewards", "dones", "time_outs", "policy_version", "policy_id",
)


@dataclass
class SamplerState:
    """Carried across rollouts. All tensors lead with the env axis [N, ...]."""

    env_states: Dict[str, torch.Tensor]
    obs: Dict[str, torch.Tensor]
    rnn_state: torch.Tensor
    generator: torch.Generator  # every draw of the policy and the env
    ep_return: torch.Tensor  # running, not yet completed episodes
    ep_len: torch.Tensor
    ep_return_raw: torch.Tensor  # before reward scaling/clipping
    # runtime reward-shaping coefficients (PBT): floats, or [P] tensors in the mixed-policy state
    shaping: Optional[Dict[str, Any]] = None


def init_sampler_state(cfg, env: DeviceEnv, num_envs: int, device, generator: torch.Generator) -> SamplerState:
    obs, env_states = env.reset(num_envs, device, generator=generator)
    shaping = None
    if getattr(env, "supports_dynamic_shaping", False) and env.reward_shaping:
        shaping = dict(env.reward_shaping)
    zeros = torch.zeros(num_envs, device=device)
    return SamplerState(
        env_states=env_states,
        obs=obs,
        rnn_state=initial_actor_critic_state(cfg, num_envs, device),
        generator=generator,
        ep_return=zeros,
        ep_len=zeros.clone(),
        ep_return_raw=zeros.clone(),
        shaping=shaping,
    )


def _process_rewards(cfg, rewards):
    """Reward scale/clip (reference batched_sampling.py:208-214)."""
    return (rewards * cfg.reward_scale).clamp(-cfg.reward_clip, cfg.reward_clip)


def _static_preprocess(cfg, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Static obs preprocessing: cast + subtract-mean/scale, on the "obs" key only
    (reference utils/normalize.py:60-67). Integer observations under other keys
    (token ids) pass through untouched."""
    sub, scale = cfg.obs_subtract_mean, cfg.obs_scale
    out = {}
    for k, v in obs.items():
        if k != "obs" and not v.is_floating_point() and v.dtype != torch.bool:
            out[k] = v
            continue
        x = v.float()
        if k == "obs":
            if sub != 0.0:
                x = x - sub
            if scale != 1.0:
                x = x / scale
        out[k] = x
    return out


def normalize_obs(cfg, obs_rms, obs):
    pre = _static_preprocess(cfg, obs)
    return obs_rms_normalize(obs_rms, pre) if obs_rms is not None else pre


def make_rollout_fn(cfg, env: DeviceEnv, env_info) -> Callable:
    """Build rollout(model, obs_rms, sampler_state, policy_version, policy_id)
    -> (sampler_state, trajectory, episodic_stats). The sampler state is updated in place."""
    action_space = env_info.action_space
    a_dtype = torch.int32 if action_dtype(action_space) == "int32" else torch.float32

    @torch.no_grad()
    def rollout(model, obs_rms, ss: SamplerState, policy_version: int, policy_id: int):
        steps = []
        completed = {"count": 0.0, "return_sum": 0.0, "raw_return_sum": 0.0, "len_sum": 0.0}
        for _ in range(cfg.rollout):
            action_params, values, new_rnn = model(normalize_obs(cfg, obs_rms, ss.obs), ss.rnn_state)
            # optional action masking: the env publishes a mask under obs['action_mask']
            dist = get_action_distribution(action_space, action_params, ss.obs.get("action_mask"))
            actions, log_probs = sample_actions_log_probs(dist, ss.generator)
            actions = actions.to(a_dtype)

            next_obs, env_states, rewards, dones, info = autoreset_step(
                env, ss.env_states, actions, generator=ss.generator, shaping=ss.shaping
            )
            proc_rewards = _process_rewards(cfg, rewards)

            # episodic bookkeeping: accumulate, emit on done, reset accumulators
            ep_return = ss.ep_return + proc_rewards
            ep_return_raw = ss.ep_return_raw + rewards
            ep_len = ss.ep_len + 1.0
            done_f = dones.float()
            completed["count"] = completed["count"] + done_f.sum()
            completed["return_sum"] = completed["return_sum"] + (done_f * ep_return).sum()
            completed["raw_return_sum"] = completed["raw_return_sum"] + (done_f * ep_return_raw).sum()
            completed["len_sum"] = completed["len_sum"] + (done_f * ep_len).sum()

            steps.append({
                "obs": ss.obs,
                "rnn_states": ss.rnn_state,
                "actions": actions,
                "action_logits": action_params,
                "log_prob_actions": log_probs,
                "values": values,
                "rewards": proc_rewards,
                "dones": done_f,
                "time_outs": info["time_outs"].float(),
                "policy_version": torch.full(values.shape, policy_version, dtype=torch.int32, device=values.device),
                "policy_id": torch.full(values.shape, policy_id, dtype=torch.int32, device=values.device),
            })

            # rnn state resets at episode boundaries (reference batched_sampling.py:215-228)
            ss.rnn_state = torch.where(done_f[:, None] > 0, torch.zeros_like(new_rnn), new_rnn)
            ss.env_states, ss.obs = env_states, next_obs
            keep = 1.0 - done_f
            ss.ep_return, ss.ep_len, ss.ep_return_raw = ep_return * keep, ep_len * keep, ep_return_raw * keep

        return ss, _stack_trajectory(steps, ss), completed

    return rollout


def _stack_trajectory(steps, ss: SamplerState) -> Dict[str, Any]:
    """Time-major trajectory of the collected steps, with T+1 obs and rnn entries for the
    bootstrap value (reference batched_sampling.py:289-296)."""
    traj: Dict[str, Any] = {k: torch.stack([s[k] for s in steps]) for k in TRAJECTORY_KEYS if k != "obs"}
    traj["obs"] = {k: torch.stack([s["obs"][k] for s in steps] + [ss.obs[k]]) for k in ss.obs}
    traj["rnn_states"] = torch.cat([traj["rnn_states"], ss.rnn_state[None]], dim=0)
    return traj


def init_mixed_sampler_state(cfg, env: DeviceEnv, num_envs: int, num_policies: int, device, generator) -> SamplerState:
    """Sampler state for multi-agent envs with within-env policy mixing (:159-184): obs, rnn
    state and the episodic accumulators are slot-major ([num_envs * num_agents, ...]), the env
    states stay env-major. Shaping, where the env takes it at run time, is one [P] tensor per
    coefficient, gathered per slot at rollout time, so that PBT can change one policy's row."""
    slots = num_envs * env.num_agents
    obs, env_states = env.reset(num_envs, device, generator=generator)  # obs [N, A, ...]
    shaping = None
    if getattr(env, "supports_dynamic_shaping", False) and env.reward_shaping:
        shaping = {k: torch.full((num_policies,), float(v), device=device) for k, v in env.reward_shaping.items()}
    zeros = torch.zeros(slots, device=device)
    return SamplerState(
        env_states=env_states,
        obs={k: v.reshape((slots,) + tuple(v.shape[2:])) for k, v in obs.items()},
        rnn_state=initial_actor_critic_state(cfg, slots, device),
        generator=generator,
        ep_return=zeros,
        ep_len=zeros.clone(),
        ep_return_raw=zeros.clone(),
        shaping=shaping,
    )


def make_mixed_rollout_fn(cfg, env: DeviceEnv, env_info, num_policies: int) -> Callable:
    """Build rollout(models, obs_rms, sampler_state, slot_policies, policy_versions)
    -> (sampler_state, trajectory [T, slots, ...], episodic_stats {key: [P]}) (:187-302).
    `models` and `obs_rms` are lists of P (obs_rms may be None), `slot_policies` the policy
    index of each slot as a host array [slots] (so that grouping the slots costs no device
    sync), `policy_versions` P ints. The sampler state is updated in place."""
    action_space = env_info.action_space
    a_dtype = torch.int32 if action_dtype(action_space) == "int32" else torch.float32
    A, P = env.num_agents, num_policies

    def mixed_policy_step(models, obs_rms, ss, groups):
        """Each policy's forward and action draw on its own slots; results in slot order."""
        slots = ss.rnn_state.shape[0]
        merged = None
        for p, idx in groups:
            obs = {k: v.index_select(0, idx) for k, v in ss.obs.items()}
            rms = None if obs_rms is None else obs_rms[p]
            action_params, values, new_rnn = models[p](normalize_obs(cfg, rms, obs), ss.rnn_state.index_select(0, idx))
            dist = get_action_distribution(action_space, action_params, obs.get("action_mask"))
            actions, log_probs = sample_actions_log_probs(dist, ss.generator)
            outs = (actions.to(a_dtype), log_probs, action_params, values, new_rnn)
            if merged is None:
                merged = [torch.empty((slots,) + tuple(o.shape[1:]), dtype=o.dtype, device=o.device) for o in outs]
            for full, part in zip(merged, outs):
                full.index_copy_(0, idx, part)
        return merged

    @torch.no_grad()
    def rollout(models, obs_rms, ss: SamplerState, slot_policies, policy_versions):
        on_host = [int(p) for p in slot_policies]
        slots = len(on_host)
        num_envs = slots // A
        device = ss.rnn_state.device
        slot_policies = torch.tensor(on_host, dtype=torch.long, device=device)
        onehot = torch.nn.functional.one_hot(slot_policies, P).float()  # [slots, P]
        slot_versions = torch.tensor([int(policy_versions[p]) for p in on_host], dtype=torch.int32, device=device)
        slot_ids = slot_policies.int()
        groups = [(p, torch.tensor(rows, dtype=torch.long, device=device))
                  for p in range(P) if (rows := [s for s, q in enumerate(on_host) if q == p])]

        # per-agent shaping gathered from the per-policy rows
        shaping = None
        if ss.shaping is not None:
            shaping = {k: v[slot_policies].reshape(num_envs, A) for k, v in ss.shaping.items()}

        steps = []
        completed = {k: torch.zeros(P, device=device) for k in ("count", "return_sum", "raw_return_sum", "len_sum")}
        for _ in range(cfg.rollout):
            actions, log_probs, action_params, values, new_rnn = mixed_policy_step(models, obs_rms, ss, groups)

            env_actions = actions.reshape((num_envs, A) + tuple(actions.shape[1:]))
            next_obs, env_states, rewards, dones, info = autoreset_step_ma(
                env, ss.env_states, env_actions, generator=ss.generator, shaping=shaping
            )
            # flatten the agent axis back into slots
            rewards, dones = rewards.reshape(slots), dones.reshape(slots)
            next_obs = {k: v.reshape((slots,) + tuple(v.shape[2:])) for k, v in next_obs.items()}

            proc_rewards = _process_rewards(cfg, rewards)
            ep_return = ss.ep_return + proc_rewards
            ep_return_raw = ss.ep_return_raw + rewards
            ep_len = ss.ep_len + 1.0
            done_f = dones.float()
            completed["count"] += done_f @ onehot
            completed["return_sum"] += (done_f * ep_return) @ onehot
            completed["raw_return_sum"] += (done_f * ep_return_raw) @ onehot
            completed["len_sum"] += (done_f * ep_len) @ onehot

            steps.append({
                "obs": ss.obs,
                "rnn_states": ss.rnn_state,
                "actions": actions,
                "action_logits": action_params,
                "log_prob_actions": log_probs,
                "values": values,
                "rewards": proc_rewards,
                "dones": done_f,
                "time_outs": info["time_outs"].reshape(slots).float(),
                "policy_version": slot_versions,
                # inactive agents get policy_id -1: masked out by every learner's valids
                "policy_id": torch.where(info["active"].reshape(slots), slot_ids, torch.full_like(slot_ids, -1)),
            })

            ss.rnn_state = torch.where(done_f[:, None] > 0, torch.zeros_like(new_rnn), new_rnn)
            ss.env_states, ss.obs = env_states, next_obs
            keep = 1.0 - done_f
            ss.ep_return, ss.ep_len, ss.ep_return_raw = ep_return * keep, ep_len * keep, ep_return_raw * keep

        return ss, _stack_trajectory(steps, ss), completed

    return rollout
