"""Evaluation of a trained policy.

Counterpart of `sample_factory_tpu/enjoy.py` (reference
`sample_factory/enjoy.py:103-292`: checkpoint load, config merge,
deterministic-argmax option, episode bookkeeping). On-device envs are stepped
in a batch of `num_envs`; `--policy_index=p` takes `checkpoint_p{p}` of a
population run (single-agent envs: as in the JAX package, there is no
multi-agent loop here); the host-env loop (render, video, hub) waits for the
host sampler (ROADMAP A11).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import torch

from sample_factory_tpu_torch.algo.distributions import argmax_actions, get_action_distribution
from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import init_sampler_state, normalize_obs
from sample_factory_tpu_torch.cfg.arguments import load_from_checkpoint
from sample_factory_tpu_torch.envs.device_env import autoreset_step
from sample_factory_tpu_torch.envs.env_info import extract_env_info
from sample_factory_tpu_torch.envs.env_utils import create_env
from sample_factory_tpu_torch.envs.spaces import action_dtype
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.utils.utils import log, resolve_device


def enjoy(cfg, num_episodes: Optional[int] = None, num_envs: int = 16, collect_episodes: Optional[list] = None) -> Tuple[int, float]:
    """Returns (status, avg_episode_reward). If collect_episodes is a list, it is filled
    with per-episode (reward, length) tuples. The saved config of the training run is
    loaded first; flags typed on the command line override it (--device among them)."""
    cfg = load_from_checkpoint(cfg)
    device = resolve_device(cfg)
    max_episodes = num_episodes if num_episodes is not None else min(cfg.max_num_episodes, 100)

    env = create_env(cfg.env, cfg=cfg, env_config=None, render_mode=None)  # host envs raise here (ROADMAP A11)
    env_info = extract_env_info(env, cfg)
    seed = cfg.seed if cfg.seed is not None else 0
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(seed))
    model.to(device)
    ts = init_train_state(cfg, env_info, model, device)
    restored = load_checkpoint(cfg, cfg.policy_index, ts)
    if restored is None:
        log.error("No checkpoint found for policy %d", cfg.policy_index)
        return 1, 0.0
    log.info("Evaluating checkpoint at %d env steps", restored[0])

    generator = torch.Generator(device).manual_seed(seed + 1)
    ss = init_sampler_state(cfg, env, num_envs, device, generator)
    a_dtype = torch.int32 if action_dtype(env_info.action_space) == "int32" else torch.float32

    @torch.no_grad()
    def eval_step():
        action_params, _, new_rnn = model(normalize_obs(cfg, ts.obs_rms, ss.obs), ss.rnn_state)
        dist = get_action_distribution(env_info.action_space, action_params, ss.obs.get("action_mask"))
        actions = argmax_actions(dist) if cfg.eval_deterministic else dist.sample(generator)
        ss.obs, ss.env_states, rewards, dones, _ = autoreset_step(env, ss.env_states, actions.to(a_dtype), generator=generator)
        done_f = dones.float()
        ep_return, ep_len = ss.ep_return + rewards, ss.ep_len + 1.0
        ss.rnn_state = torch.where(done_f[:, None] > 0, torch.zeros_like(new_rnn), new_rnn)
        ss.ep_return, ss.ep_len = ep_return * (1.0 - done_f), ep_len * (1.0 - done_f)
        # per-env done mask with the final return and length, so that single episodes can be told apart
        return dones, ep_return, ep_len

    episodes, reward_sum, len_sum, frames = 0, 0.0, 0.0, 0
    start = time.time()
    while episodes < max_episodes and frames < cfg.max_num_frames:
        dones, ep_returns, ep_lens = eval_step()
        dones = dones.cpu()
        rets, lens = ep_returns.cpu()[dones], ep_lens.cpu()[dones]
        episodes += int(dones.sum())
        reward_sum += float(rets.sum())
        len_sum += float(lens.sum())
        if collect_episodes is not None:
            collect_episodes.extend(zip(rets.tolist(), lens.int().tolist()))
        frames += num_envs
        if time.time() - start > 600:
            log.warning("Evaluation timed out")
            break

    avg_reward = reward_sum / max(1, episodes)
    avg_len = len_sum / max(1, episodes)
    log.info("Avg episode reward: %.3f, avg episode len: %.1f over %d episodes", avg_reward, avg_len, episodes)
    return 0, avg_reward


def enjoy_host(cfg, max_episodes: int, collect_episodes: Optional[list] = None) -> Tuple[int, float]:
    raise NotImplementedError("enjoy on host (gymnasium) envs is not ported yet (ROADMAP A11)")


def main() -> int:
    """Evaluate any env of `examples.train_synthetic` from its checkpoint:
    python -m sample_factory_tpu_torch.enjoy --env=... --experiment=... --no_render"""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components

    register_synthetic_components()
    status, _ = enjoy(parse_custom_args(evaluation=True))
    return status


if __name__ == "__main__":
    sys.exit(main())
