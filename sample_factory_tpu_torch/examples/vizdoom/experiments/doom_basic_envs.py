"""Grid over the basic single-player Doom scenarios, 3 seeds each
for the port's launcher: counterpart of
`sf_examples_tpu/vizdoom/experiments/doom_basic_envs.py` (reference
experiments/paper_doom_all_basic_envs.py). Run with
`python -m sample_factory_tpu_torch.launcher.run --run=sample_factory_tpu_torch.examples.vizdoom.experiments.doom_basic_envs`."""

from sample_factory_tpu_torch.launcher.run_description import Experiment, ParamGrid, RunDescription

_params = ParamGrid(
    [
        ("seed", [0, 1111, 2222]),
        (
            "env",
            [
                "doom_my_way_home",
                "doom_deadly_corridor",
                "doom_defend_the_center",
                "doom_defend_the_line",
                "doom_health_gathering",
                "doom_health_gathering_supreme",
            ],
        ),
    ]
)

_cmd = (
    "python -m sample_factory_tpu_torch.examples.vizdoom.train_vizdoom "
    "--train_for_env_steps=500000000 --env_frameskip=4 --use_rnn=True "
    "--num_workers=16 --num_envs_per_worker=16 --batch_size=2048 --num_epochs=1"
)

_experiments = [Experiment("doom_basic_envs", _cmd, _params.generate_params(randomize=False))]

RUN_DESCRIPTION = RunDescription("doom_basic_envs", experiments=_experiments)
