"""Per-process global context: env registry + model factory.

Copy of `sample_factory_tpu/algo/context.py` (reference
`sample_factory/algo/utils/context.py:7-34` and `model/model_factory.py`).
The port keeps its own registry: registering an env here does not register it
with the JAX package, and the reverse. Tests reset it between runs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class ModelFactory:
    """User-overridable factories (reference model_factory.py:31-60)."""

    def __init__(self):
        self.encoder_factory: Optional[Callable] = None
        self.core_factory: Optional[Callable] = None
        self.decoder_factory: Optional[Callable] = None
        self.actor_critic_factory: Optional[Callable] = None

    def register_encoder_factory(self, fn: Callable) -> None:
        """fn(cfg, obs_space) -> nn.Module with get_out_size()"""
        self.encoder_factory = fn

    def register_model_core_factory(self, fn: Callable) -> None:
        """fn(cfg, input_size) -> nn.Module with get_out_size() (torch layers need their input width)"""
        self.core_factory = fn

    def register_decoder_factory(self, fn: Callable) -> None:
        """fn(cfg, input_size) -> nn.Module with get_out_size()"""
        self.decoder_factory = fn

    def register_actor_critic_factory(self, fn: Callable) -> None:
        """fn(cfg, obs_space, action_space) -> nn.Module"""
        self.actor_critic_factory = fn


class SfContext:
    def __init__(self):
        self.env_registry: Dict[str, object] = {}
        self.model_factory = ModelFactory()


_GLOBAL_CONTEXT: Optional[SfContext] = None


def sf_global_context() -> SfContext:
    global _GLOBAL_CONTEXT
    if _GLOBAL_CONTEXT is None:
        _GLOBAL_CONTEXT = SfContext()
    return _GLOBAL_CONTEXT


def reset_global_context() -> None:
    global _GLOBAL_CONTEXT
    _GLOBAL_CONTEXT = None


def global_model_factory() -> ModelFactory:
    return sf_global_context().model_factory


def global_env_registry() -> Dict[str, object]:
    return sf_global_context().env_registry
