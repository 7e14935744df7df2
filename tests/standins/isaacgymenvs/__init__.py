"""A stand-in for IsaacGymEnvs (`isaacgymenvs`): `tasks.isaacgym_task_map`, the hydra configs under
`cfg/` (config.yaml and one task file per task, read by the stand-in `hydra`) and
`utils.reformat.omegaconf_to_dict`. See `tasks/__init__.py` for the simulated tasks."""

import isaacgym  # noqa: F401  # as IsaacGymEnvs does: isaacgym before torch
