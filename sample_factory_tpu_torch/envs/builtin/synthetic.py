"""Built-in on-device envs by name (counterpart of `sample_factory_tpu/envs/builtin/synthetic.py`).

Ported so far: `grid_battle` (24x24x3, 8 enemies) and `grid_battle_small`
(12x12x3, 4 enemies), with the JAX package's settings (:150-157). The other
synthetic envs of the JAX package follow in a later slice (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv

NOT_PORTED = ("synthetic_discrete", "synthetic_vector_discrete", "synthetic_continuous", "synthetic_tuple", "synthetic_masked")
ENV_NAMES = ("grid_battle", "grid_battle_small")


def make_synthetic_env(full_env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    if full_env_name == "grid_battle":
        return GridBattleEnv()
    if full_env_name == "grid_battle_small":
        return GridBattleEnv(size=12, num_enemies=4, episode_len=128, shoot_range=5)
    if full_env_name in NOT_PORTED:
        raise NotImplementedError(f"{full_env_name} is not ported to the PyTorch package yet (ROADMAP: synthetic envs)")
    raise ValueError(f"Unknown synthetic env {full_env_name}")
