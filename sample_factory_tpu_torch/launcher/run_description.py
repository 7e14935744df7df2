"""Experiment grids: describe sweeps as parameter generators -> command lines.

Parity: reference `sample_factory/launcher/run_description.py` — ParamGrid
(:37), ParamList (:20), Experiment (:89), RunDescription (:143,
generate_experiments :174). Same public surface; fresh implementation.
"""

from __future__ import annotations

import itertools
import os
import re
from collections import OrderedDict
from os.path import join
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from sample_factory_tpu_torch.utils.utils import log


class ParamGenerator:
    def generate_params(self, randomize: bool = True):
        raise NotImplementedError


class ParamList(ParamGenerator):
    """A plain list of parameter-combination dicts."""

    def __init__(self, combinations: Sequence[Dict]):
        self.combinations = list(combinations)

    def generate_params(self, randomize: bool = True):
        combos = list(self.combinations)
        if randomize:
            rng = np.random.default_rng()
            combos = [combos[i] for i in rng.permutation(len(combos))]
        yield from combos


class ParamGrid(ParamGenerator):
    """Cartesian product over (name, values) tuples. A name may itself be a
    tuple of names paired with tuple-values (coupled parameters)."""

    def __init__(self, grid_tuples: Sequence[Tuple]):
        self.grid = OrderedDict(grid_tuples)

    def generate_params(self, randomize: bool = False):
        if not self.grid:
            yield dict()
            return
        names = list(self.grid.keys())
        combos = list(itertools.product(*self.grid.values()))
        if randomize:
            rng = np.random.default_rng()
            combos = [combos[i] for i in rng.permutation(len(combos))]
        for combo in combos:
            d: Dict = OrderedDict()
            for name, value in zip(names, combo):
                if isinstance(name, (list, tuple)):
                    for n, v in zip(name, value):
                        d[n] = v
                else:
                    d[name] = value
            yield d


class Experiment:
    def __init__(self, name: str, cmd: str, param_generator: Iterable = (), env_vars: Optional[Dict] = None):
        self.base_name = name
        self.cmd = cmd
        self.params = list(param_generator)
        self.env_vars = env_vars

    def generate_experiments(self, experiment_arg_name: str, customize_experiment_name: bool, param_prefix: str):
        """Yields (cmd, experiment_name)."""
        num_experiments = 1 if not self.params else len(self.params)
        for experiment_idx in range(num_experiments):
            cmd_tokens = [self.cmd]
            experiment_name = self.base_name
            if self.params:
                params = self.params[experiment_idx]
                for param, value in params.items():
                    param_str = f"{param_prefix}{param}={_param_to_str(value)}"
                    cmd_tokens.append(param_str)
                if customize_experiment_name:
                    suffix = "_".join(f"{_shorten(p)}_{_param_to_str(v)}" for p, v in params.items())
                    suffix = re.sub(r"[^0-9a-zA-Z_\-.]+", "_", suffix)
                    experiment_name = f"{self.base_name}_{suffix}"[:140]
            cmd_tokens.append(f"{experiment_arg_name}={experiment_name}")
            yield " ".join(cmd_tokens), experiment_name


def _param_to_str(value) -> str:
    if isinstance(value, (list, tuple)):
        return " ".join(str(v) for v in value)
    return str(value)


def _shorten(param: str, max_len: int = 24) -> str:
    return param if len(param) <= max_len else param[:max_len]


class RunDescription:
    def __init__(
        self,
        run_name: str,
        experiments: Sequence[Experiment],
        experiment_arg_name: str = "--experiment",
        experiment_dir_arg_name: str = "--train_dir",
        customize_experiment_name: bool = True,
        param_prefix: str = "--",
    ):
        self.run_name = run_name
        self.experiments = list(experiments)
        self.experiment_arg_name = experiment_arg_name
        self.experiment_dir_arg_name = experiment_dir_arg_name
        self.customize_experiment_name = customize_experiment_name
        self.param_prefix = param_prefix
        self.experiment_suffix = ""

    def generate_experiments(self, train_dir: str, makedirs: bool = True):
        """Yields (cmd, name, root_dir, env_vars) for every experiment in the run."""
        for experiment in self.experiments:
            root_dir = join(self.run_name, f"{experiment.base_name}_{self.experiment_suffix}" if self.experiment_suffix else experiment.base_name)
            gen = experiment.generate_experiments(
                self.experiment_arg_name, self.customize_experiment_name, self.param_prefix
            )
            for cmd, name in gen:
                cmd = f"{cmd} {self.experiment_dir_arg_name}={join(train_dir, root_dir)}"
                if makedirs:
                    os.makedirs(join(train_dir, root_dir), exist_ok=True)
                yield cmd, name, root_dir, experiment.env_vars
