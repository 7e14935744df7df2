"""Launcher grid over the basic IsaacGym tasks.

Counterpart of `sf_examples_tpu/isaacgym_examples/experiments/isaacgym_basic_envs.py` (reference
`sf_examples/isaacgym_examples/experiments/isaacgym_basic_envs.py`). Run:
    python -m sample_factory_tpu_torch.launcher.run \
        --run=sample_factory_tpu_torch.examples.isaacgym_examples.experiments.isaacgym_basic_envs --backend=processes
"""

from sample_factory_tpu_torch.launcher.run_description import Experiment, ParamGrid, RunDescription

_params = ParamGrid([
    ("seed", [1111, 2222, 3333]),
    ("env", ["Ant", "Humanoid"]),
])

_experiment = Experiment(
    "isaacgym_basic",
    "python -m sample_factory_tpu_torch.examples.isaacgym_examples.train_isaacgym --train_for_env_steps=100000000",
    _params.generate_params(randomize=False),
)

RUN_DESCRIPTION = RunDescription("isaacgym_basic_envs", experiments=[_experiment])
