"""The paper's headline experiment: doom_battle / doom_battle2 with a
recurrent policy (GRU-512, float32: the cfg's defaults), for the port's launcher:
counterpart of `sf_examples_tpu/vizdoom/experiments/doom_battle_appo.py` (reference
experiments/paper_doom_battle_appo.py and doom_battle_battle2_appo.py)."""

from sample_factory_tpu_torch.launcher.run_description import Experiment, ParamGrid, RunDescription

_params = ParamGrid(
    [
        ("seed", [1111, 2222, 3333]),
        ("env", ["doom_battle", "doom_battle2"]),
    ]
)

_cmd = (
    "python -m sample_factory_tpu_torch.examples.vizdoom.train_vizdoom "
    "--train_for_env_steps=4000000000 --env_frameskip=4 --use_rnn=True "
    "--reward_scale=0.5 --num_workers=20 --num_envs_per_worker=20 "
    "--batch_size=2048 --wide_aspect_ratio=False"
)

_experiments = [Experiment("battle_fs4", _cmd, _params.generate_params(randomize=False))]

RUN_DESCRIPTION = RunDescription("doom_battle_appo", experiments=_experiments)
