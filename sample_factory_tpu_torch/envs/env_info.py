"""EnvInfo: static metadata extracted from one probe env instance
(counterpart of `sample_factory_tpu/envs/env_info.py`; reference
`sample_factory/algo/utils/env_info.py:22-134`).

On-device envs are stateless containers, so the probe runs inline; the JAX
package's spawned probe process and its disk cache serve host envs, which
the port does not drive yet (ROADMAP A11). `--use_env_info_cache` is accepted
and has no effect here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from sample_factory_tpu_torch.envs.env_utils import create_env
from sample_factory_tpu_torch.envs.spaces import obs_space_as_dict


@dataclass
class EnvInfo:
    obs_space: Any
    action_space: Any
    num_agents: int
    is_device_env: bool
    frameskip: int = 1
    reward_shaping_scheme: Optional[Dict[str, float]] = None


def extract_env_info(env, cfg) -> EnvInfo:
    return EnvInfo(
        obs_space=obs_space_as_dict(env.obs_space),
        action_space=env.action_space,
        num_agents=env.num_agents,
        is_device_env=True,
        frameskip=getattr(env, "frameskip", 1) if cfg is None else cfg.env_frameskip,
        reward_shaping_scheme=dict(env.reward_shaping) if env.reward_shaping else None,
    )


def obtain_env_info(cfg, register_fn=None) -> EnvInfo:
    """Build one probe env and extract its info. `register_fn` registers envs inside
    host-env worker processes in the JAX package; on-device envs need none."""
    return extract_env_info(create_env(cfg.env, cfg=cfg, env_config=None), cfg)
