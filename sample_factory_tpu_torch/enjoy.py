"""Evaluation of a trained policy.

Counterpart of `sample_factory_tpu/enjoy.py` (reference
`sample_factory/enjoy.py:103-292`: checkpoint load, config merge,
deterministic-argmax option, episode bookkeeping). On-device envs are stepped
in a batch of `num_envs`; `--policy_index=p` takes `checkpoint_p{p}` of a
population run (single-agent envs: as in the JAX package, there is no
multi-agent device loop here). A host (gymnasium) env goes to `enjoy_host`: one
env stepped in this process (single- or multi-agent, or a batched vector env as
a batch of one), with `--no_render`, a window (`render_mode="human"`) or, with
`--save_video`, frames (`render_mode="rgb_array"`) written to a replay video;
`--push_to_hub` then writes a model card and pushes the experiment directory
(`hub/huggingface_hub_utils.py`). Both loops act through the policy that
`export_model` exports (`build_inference_fn`).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from sample_factory_tpu_torch.algo.learning import init_train_state
from sample_factory_tpu_torch.algo.sampling import init_sampler_state
from sample_factory_tpu_torch.cfg.arguments import load_from_checkpoint
from sample_factory_tpu_torch.envs.device_env import autoreset_step
from sample_factory_tpu_torch.envs.env_info import extract_env_info
from sample_factory_tpu_torch.envs.env_utils import create_env, is_device_env
from sample_factory_tpu_torch.export_model import build_inference_fn
from sample_factory_tpu_torch.models.actor_critic import create_actor_critic
from sample_factory_tpu_torch.runner.checkpoint import load_checkpoint
from sample_factory_tpu_torch.utils.utils import experiment_dir, log, resolve_device


def enjoy(cfg, num_episodes: Optional[int] = None, num_envs: int = 16, collect_episodes: Optional[list] = None) -> Tuple[int, float]:
    """Returns (status, avg_episode_reward). If collect_episodes is a list, it is filled
    with per-episode (reward, length) tuples. The saved config of the training run is
    loaded first; flags typed on the command line override it (--device among them)."""
    cfg = load_from_checkpoint(cfg)
    device = resolve_device(cfg)
    max_episodes = num_episodes if num_episodes is not None else min(cfg.max_num_episodes, 100)

    env = create_env(cfg.env, cfg=cfg, env_config=None, render_mode=None)
    if not is_device_env(env):
        if hasattr(env, "close"):
            env.close()
        return enjoy_host(cfg, max_episodes, collect_episodes)
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
    policy = build_inference_fn(cfg, env_info, model, ts, deterministic=cfg.eval_deterministic)

    @torch.no_grad()
    def eval_step():
        noise = None if policy.deterministic else policy.draw_noise(num_envs, generator)
        actions, new_rnn = policy(ss.obs, ss.rnn_state, noise)
        ss.obs, ss.env_states, rewards, dones, _ = autoreset_step(env, ss.env_states, actions, generator=generator)
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
    """Single host (gymnasium) env visualization/eval loop (counterpart of
    `sample_factory_tpu/enjoy.py:124-262`; reference enjoy.py:103-292): optional
    deterministic argmax, frameskip-compensating action repeat at eval time. `cfg` is the
    merged config `enjoy` made."""
    from sample_factory_tpu_torch.algo.host_worker import _convert_host_action
    from sample_factory_tpu_torch.envs.gym_wrappers import wrap_host_env
    from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state

    render_mode = None
    if cfg.save_video:
        render_mode = "rgb_array"
    elif not cfg.no_render:
        render_mode = "human"
    device = resolve_device(cfg)

    # eval-time frameskip override: repeat each policy action so that the effective
    # frameskip matches training (reference enjoy.py:108-114)
    train_frameskip = cfg.env_frameskip
    if cfg.eval_env_frameskip is not None:
        cfg.env_frameskip = cfg.eval_env_frameskip
    render_action_repeat = max(1, train_frameskip // max(1, cfg.env_frameskip))

    env = create_env(cfg.env, cfg=cfg, env_config=None, render_mode=render_mode)
    # a batched vector env built without a split size is a batch of one env (auto-resetting)
    batched = getattr(env, "is_batched_vector_env", False)
    multiagent = getattr(env, "is_multiagent", False)
    if not multiagent and not batched:
        env = wrap_host_env(env, cfg)
    num_agents = env.num_agents if multiagent else 1
    env_info = extract_env_info(env, cfg)

    def to_batched_obs(obs):
        """Single-agent dict obs or multi-agent list -> dict of [A, ...] tensors on the device."""
        if batched:
            return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in (obs if isinstance(obs, dict) else {"obs": obs}).items()}
        if not multiagent:
            return {k: torch.as_tensor(np.asarray(v)[None]).to(device) for k, v in obs.items()}
        per_agent = [o if isinstance(o, dict) else {"obs": o} for o in obs]
        return {k: torch.as_tensor(np.stack([o[k] for o in per_agent])).to(device) for k in per_agent[0]}

    seed = cfg.seed if cfg.seed is not None else 0
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(seed))
    model.to(device)
    ts = init_train_state(cfg, env_info, model, device)
    restored = load_checkpoint(cfg, cfg.policy_index, ts)
    if restored is None:
        log.error("No checkpoint found for policy %d", cfg.policy_index)
        env.close()
        return 1, 0.0
    log.info("Evaluating checkpoint at %d env steps", restored[0])

    generator = torch.Generator(device).manual_seed(seed + 1)
    policy = build_inference_fn(cfg, env_info, model, ts, deterministic=cfg.eval_deterministic)

    @torch.no_grad()
    def policy_step(obs, rnn_state):
        return policy(obs, rnn_state, None if policy.deterministic else policy.draw_noise(rnn_state.shape[0], generator))

    obs, _ = env.reset(seed=cfg.seed)
    rnn = initial_actor_critic_state(cfg, num_agents, device)
    frames = []
    episodes, reward_sum, len_sum = 0, 0.0, 0.0
    ep_reward, ep_len, total_frames = np.zeros(num_agents), 0, 0
    fps_delay = 1.0 / cfg.fps if cfg.fps > 0 else 0.0

    def render_frame():
        if render_mode == "rgb_array" and len(frames) < cfg.video_frames:
            frames.append(env.render())
        elif render_mode == "human":
            env.render()
            if fps_delay:
                time.sleep(fps_delay)

    while episodes < max_episodes and total_frames < cfg.max_num_frames:
        actions, rnn = policy_step(to_batched_obs(obs), rnn)
        acts = actions.cpu().numpy()

        done = False
        for _ in range(render_action_repeat):
            if multiagent:
                action_list = [_convert_host_action(env.action_space, acts[a]) for a in range(num_agents)]
                obs, rewards, terms, truncs, _ = env.step(action_list)
                ep_reward += np.asarray(rewards, np.float64)
                done = all(bool(t) or bool(tr) for t, tr in zip(terms, truncs))
            elif batched:
                discrete = type(env_info.action_space).__name__ == "Discrete"
                obs, reward, terminated, truncated, _ = env.step(acts[:, 0] if discrete else acts)
                ep_reward += float(reward[0])
                done = bool(terminated[0] or truncated[0])
            else:
                obs, reward, terminated, truncated, _ = env.step(_convert_host_action(env.action_space, acts[0]))
                ep_reward += float(reward)
                done = terminated or truncated
            ep_len += 1
            total_frames += 1
            render_frame()
            if done:
                break

        if done:
            episodes += 1
            ep_rew = float(ep_reward.mean())
            reward_sum += ep_rew
            len_sum += ep_len
            if collect_episodes is not None:
                collect_episodes.append((ep_rew, ep_len))
            log.info("Episode %d: reward %.3f, length %d", episodes, ep_rew, ep_len)
            ep_reward, ep_len = np.zeros(num_agents), 0
            rnn = initial_actor_critic_state(cfg, num_agents, device)
            if not batched:  # a batched vector env has reset itself
                obs, _ = env.reset()

    env.close()
    avg_reward = reward_sum / max(1, episodes)
    log.info("Avg episode reward: %.3f over %d episodes", avg_reward, episodes)

    if cfg.save_video and frames:
        from sample_factory_tpu_torch.hub.huggingface_hub_utils import generate_replay_video

        generate_replay_video(experiment_dir(cfg), frames, cfg.fps if cfg.fps > 0 else 30, cfg)

    if cfg.push_to_hub and cfg.hf_repository:
        from sample_factory_tpu_torch.hub.huggingface_hub_utils import generate_model_card, push_to_hf

        rewards = [r for r, _ in (collect_episodes or [])] or [avg_reward]
        generate_model_card(experiment_dir(cfg), cfg.algo, cfg.env, cfg.hf_repository, rewards)
        push_to_hf(experiment_dir(cfg), cfg.hf_repository)

    return 0, avg_reward


def register_env_by_name(env_name: str):
    """Register `env_name` for the generic `enjoy` and `eval` command lines: an env of
    `examples.train_synthetic` or `envs.batched_host_env`, the matching game, else a
    gymnasium id. Returns the register function for host-env workers (None for an on-device env)."""
    import functools

    from sample_factory_tpu_torch.algo.context import global_env_registry
    from sample_factory_tpu_torch.examples.train_synthetic import register_synthetic_components

    register_synthetic_components()
    if env_name in global_env_registry():
        return None
    from sample_factory_tpu_torch.envs import batched_host_env
    from sample_factory_tpu_torch.examples import train_custom_multi_env, train_gym_env

    known = {"batched_cartpole": batched_host_env.register_batched_cartpole, "bench_host_pixel": batched_host_env.register_bench_pixel,
             train_custom_multi_env.ENV_NAME: train_custom_multi_env.register_custom_components}
    register_fn = known.get(env_name, functools.partial(train_gym_env.register_gym_env, env_name))
    register_fn()
    return register_fn


def main() -> int:
    """Evaluate a registered env, or a gymnasium env by its id, from its checkpoint:
    python -m sample_factory_tpu_torch.enjoy --env=... --experiment=... --no_render"""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    cfg = parse_custom_args(evaluation=True)
    register_env_by_name(cfg.env)
    status, _ = enjoy(cfg)
    return status


if __name__ == "__main__":
    sys.exit(main())
