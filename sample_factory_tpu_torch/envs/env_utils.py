"""Environment registry (counterpart of `sample_factory_tpu/envs/env_utils.py`;
reference `sample_factory/envs/env_utils.py:12-31` and `envs/create_env.py:13`).

The port drives batched on-device envs (`envs/device_env.py`); host gymnasium
envs follow with the host sampler (ROADMAP A11).
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
    """make_env_func(full_env_name, cfg, env_config, render_mode=None) -> DeviceEnv"""
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
    from sample_factory_tpu_torch.envs.device_env import DeviceEnv

    entry = env_registry_entry(env_name)
    env = entry.make_env_func(env_name, cfg, env_config, render_mode=render_mode)
    if not isinstance(env, DeviceEnv):
        raise NotImplementedError(f"{env_name} is a host env; the PyTorch port runs on-device envs only so far (ROADMAP A11)")
    return env
