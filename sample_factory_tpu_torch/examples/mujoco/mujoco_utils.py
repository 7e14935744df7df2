"""MuJoCo env registry (host-env path via gymnasium).

Copy of `sf_examples_tpu/mujoco/mujoco_utils.py` (reference
`sf_examples/mujoco/mujoco_utils.py`: the same env names and gym ids; v4 tasks, the
versions the reference's published returns use). Needs gymnasium and mujoco.
"""

from __future__ import annotations

from typing import Optional

MUJOCO_ENVS = {
    "mujoco_hopper": "Hopper-v4",
    "mujoco_halfcheetah": "HalfCheetah-v4",
    "mujoco_humanoid": "Humanoid-v4",
    "mujoco_ant": "Ant-v4",
    "mujoco_standup": "HumanoidStandup-v4",
    "mujoco_doublependulum": "InvertedDoublePendulum-v4",
    "mujoco_pendulum": "InvertedPendulum-v4",
    "mujoco_reacher": "Reacher-v4",
    "mujoco_walker": "Walker2d-v4",
    "mujoco_pusher": "Pusher-v4",
    "mujoco_swimmer": "Swimmer-v4",
}


def mujoco_available() -> bool:
    try:
        import mujoco  # noqa: F401

        return True
    except ImportError:
        return False


def make_mujoco_env(env_name: str, cfg=None, env_config=None, render_mode: Optional[str] = None):
    import gymnasium as gym

    return gym.make(MUJOCO_ENVS[env_name], render_mode=render_mode)


def register_mujoco_components() -> None:
    from sample_factory_tpu_torch.envs.env_utils import register_env

    for name in MUJOCO_ENVS:
        register_env(name, make_mujoco_env)
