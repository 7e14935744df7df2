"""Self-play duel with an 8-policy PBT population
for the port's launcher:
counterpart of `sf_examples_tpu/vizdoom/experiments/doom_duel_pbt.py` (reference
experiments/paper_doom_duel_pbt.py)."""

from sample_factory_tpu_torch.launcher.run_description import Experiment, ParamGrid, RunDescription

_params = ParamGrid([("seed", [0])])

_cmd = (
    "python -m sample_factory_tpu_torch.examples.vizdoom.train_vizdoom "
    "--env=doom_duel --train_for_seconds=360000 --env_frameskip=2 --use_rnn=True "
    "--num_workers=72 --num_envs_per_worker=16 --batch_size=2048 "
    "--num_policies=8 --with_pbt=True --pbt_replace_reward_gap=0.5 "
    "--pbt_replace_reward_gap_absolute=0.35 --pbt_period_env_steps=5000000 "
    "--save_milestones_sec=1800"
)

_experiments = [Experiment("duel_pbt", _cmd, _params.generate_params(randomize=False))]

RUN_DESCRIPTION = RunDescription("doom_duel_pbt", experiments=_experiments)
