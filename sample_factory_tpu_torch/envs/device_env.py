"""Batched on-device environment API.

Counterpart of `sample_factory_tpu/envs/device_env.py`. The JAX package writes
an env for one instance and `vmap`s it; here an env steps `[N, ...]` tensors
on the env's device directly. Episode-boundary semantics are the same:
`terminated` is a true MDP end, `truncated` a time limit, and
`autoreset_step` replaces finished envs with a fresh reset (:71-93).
Multi-agent envs (`num_agents = A > 1`) carry an agent axis after the env
axis and go through `autoreset_step_ma` (:101-125).

Contract (N = number of envs, every tensor leads with N):
    reset(num_envs, device, generator=None, draws=None) -> (obs_dict, state)
    step(state, actions, generator=None, draws=None, shaping=None)
        -> (obs_dict, state, reward [N] f32, terminated [N] bool, truncated [N] bool, info)
  - obs_dict: dict[str, tensor] matching `obs_space` (always a dict)
  - multi-agent: obs `[N, A, ...]`, actions `[N, A, ...]`, reward, terminated and
    truncated `[N, A]`, `info["active"]` `[N, A]` bool (all ones when the env gives
    none), shaping coefficients as `[N, A]` tensors (one policy's value per agent)
  - state: dict[str, tensor]
  - random draws: every random number an env uses comes from
    `reset_draws`/`step_draws`, which read a `torch.Generator`. `reset`/`step`
    also take the draws as tensors, so that a test can feed the JAX env's
    draws to the port and compare steps one to one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class DeviceEnv:
    """Base class. Subclasses define obs_space / action_space / num_agents and the
    draws, `_reset` and `_step`. Instances are stateless containers of static parameters."""

    obs_space: Any = None
    action_space: Any = None
    num_agents: int = 1
    frameskip: int = 1
    # optional reward shaping dict exposed to PBT (reference RewardShapingInterface)
    reward_shaping: Dict[str, float] = {}
    # True when step consumes shaping coefficients passed at run time
    supports_dynamic_shaping: bool = False

    def reset_draws(self, num_envs: int, generator: Optional[torch.Generator], device) -> Tensors:
        return {}

    def step_draws(self, num_envs: int, generator: Optional[torch.Generator], device) -> Tensors:
        return {}

    def _reset(self, num_envs: int, device, draws: Tensors) -> Tuple[Tensors, Tensors]:
        raise NotImplementedError

    def _step(self, state: Tensors, actions: torch.Tensor, draws: Tensors, shaping: Dict[str, float]):
        raise NotImplementedError

    def reset(self, num_envs: int, device, generator=None, draws: Optional[Tensors] = None):
        if draws is None:
            draws = self.reset_draws(num_envs, generator, device)
        return self._reset(num_envs, device, draws)

    def step(self, state: Tensors, actions: torch.Tensor, generator=None, draws=None, shaping=None):
        if draws is None:
            draws = self.step_draws(actions.shape[0], generator, actions.device)
        if shaping is None or not self.supports_dynamic_shaping:
            shaping = self.reward_shaping
        return self._step(state, actions, draws, shaping)


def _bcast(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N] bool against an [N, ...] value."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - 1))


def _step_and_reset(env, state, actions, done_of, generator, step_draws, reset_draws, shaping):
    """The part both auto-reset variants share: step, draw a reset for every env, and let the
    envs where `done_of(terminated, truncated)` ([N] bool) holds take it."""
    obs, new_state, reward, terminated, truncated, info = env.step(
        state, actions, generator=generator, draws=step_draws, shaping=shaping
    )
    done = done_of(terminated, truncated)
    reset_obs, reset_state = env.reset(actions.shape[0], actions.device, generator=generator, draws=reset_draws)
    new_state = {k: torch.where(_bcast(done, v), reset_state[k], v) for k, v in new_state.items()}
    obs = {k: torch.where(_bcast(done, v), reset_obs[k], v) for k, v in obs.items()}

    info = dict(info)
    info["terminated"] = terminated
    info["truncated"] = truncated
    info["time_outs"] = truncated & ~terminated
    return obs, new_state, reward, done, info


def autoreset_step(env: DeviceEnv, state: Tensors, actions, generator=None, step_draws=None, reset_draws=None, shaping=None):
    """Step + masked auto-reset on episode end (`device_env.py:71-93`).

    Returns (obs, state, reward, done, info) where `info` holds at least
    `terminated`, `truncated` and `time_outs` (truncated and not terminated,
    the flag used for value bootstrap). As in the JAX package, every env draws
    a reset, and only the finished ones take it.
    """
    return _step_and_reset(env, state, actions, lambda term, trunc: term | trunc, generator, step_draws, reset_draws, shaping)


def autoreset_step_ma(env: DeviceEnv, state: Tensors, actions, generator=None, step_draws=None, reset_draws=None, shaping=None):
    """Multi-agent variant (`device_env.py:101-125`): the env resets when ALL of its agents
    are done, and the returned `done` [N, A] is that flag for every agent of the env, since
    every agent's episode closes when the env resets. `time_outs` stays per agent."""
    obs, new_state, reward, done_env, info = _step_and_reset(
        env, state, actions, lambda term, trunc: (term | trunc).all(dim=1), generator, step_draws, reset_draws, shaping
    )
    info.setdefault("active", torch.ones_like(info["terminated"]))
    return obs, new_state, reward, done_env[:, None].expand_as(info["terminated"]), info
