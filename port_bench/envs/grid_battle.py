"""The port's own GridBattle (`sample_factory_tpu_torch/envs/builtin/grid_battle.py`) at the cell's sizes: the env is
part of the measured rollout, so the benchmark builds it and does not replace it."""

from __future__ import annotations


def make_env(params):
    from sample_factory_tpu_torch.envs.builtin.grid_battle import GridBattleEnv

    return GridBattleEnv(**params)
