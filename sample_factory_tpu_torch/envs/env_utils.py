"""Environment registry (counterpart of `sample_factory_tpu/envs/env_utils.py`;
reference `sample_factory/envs/env_utils.py:12-31` and `envs/create_env.py:13`).

One registry serves on-device envs (`envs/device_env.py`) and host envs
(gymnasium envs, multi-agent list envs, batched numpy vector envs); the runner
picks the sampling path from the created env's type. The module imports neither
torch nor gymnasium: host-env worker processes import it.
"""

from __future__ import annotations

from typing import Callable, Optional

from sample_factory_tpu_torch.algo.context import global_env_registry
from sample_factory_tpu_torch.utils.attr_dict import AttrDict
from sample_factory_tpu_torch.utils.utils import log


class EnvRegistryEntry:
    def __init__(self, env_name: str, make_env_func: Callable):
        self.env_name = env_name
        self.make_env_func = make_env_func


def register_env(env_name: str, make_env_func: Callable) -> None:
    """make_env_func(full_env_name, cfg, env_config, render_mode=None) -> DeviceEnv | host env"""
    assert callable(make_env_func), "make_env_func must be callable"
    registry = global_env_registry()
    if env_name in registry:
        log.warning("Env %s already registered, overwriting!", env_name)
    registry[env_name] = EnvRegistryEntry(env_name, make_env_func)


def env_registry_entry(env_name: str) -> EnvRegistryEntry:
    registry = global_env_registry()
    if env_name not in registry:
        raise KeyError(
            f"Env {env_name} is not registered. Known envs: {sorted(registry.keys())}. "
            f"Call register_env() before training (see sample_factory_tpu_torch/examples/)."
        )
    return registry[env_name]


def create_env(env_name: str, cfg=None, env_config: Optional[AttrDict] = None, render_mode: Optional[str] = None):
    entry = env_registry_entry(env_name)
    env = entry.make_env_func(env_name, cfg, env_config, render_mode=render_mode)
    if not is_device_env(env):
        # legacy-gym 4-tuple envs get the gymnasium shim (reference create_env applies
        # gymnasium_utils.py:22-93 patches); device envs pass through
        from sample_factory_tpu_torch.envs.gymnasium_compat import ensure_gymnasium_env

        env = ensure_gymnasium_env(env)
    return env


def is_device_env(env) -> bool:
    """Whether `env` is an on-device env. A host env declares `observation_space` (a DeviceEnv
    declares `obs_space`) and is answered without importing `envs/device_env.py`, which
    imports torch: host-env worker processes stay free of it."""
    if hasattr(env, "observation_space"):
        return False
    from sample_factory_tpu_torch.envs.device_env import DeviceEnv

    return isinstance(env, DeviceEnv)


# ---------------------------------------------------------------- PBT hooks


class RewardShapingInterface:
    """Envs that support PBT-driven reward shaping (reference env_utils.py:74-99)."""

    def get_default_reward_shaping(self):
        raise NotImplementedError

    def set_reward_shaping(self, reward_shaping, agent_idx) -> None:
        raise NotImplementedError


class TrainingInfoInterface:
    """Envs that consume training progress (curricula) (reference env_utils.py:102-133)."""

    def set_training_info(self, training_info) -> None:
        raise NotImplementedError
