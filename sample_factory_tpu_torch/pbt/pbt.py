"""Population-based training over a list of per-policy train states.

Counterpart of `sample_factory_tpu/pbt/pbt.py` (reference
`sample_factory/pbt/population_based_training.py`: HYPERPARAMS_TO_TUNE :58,
_perturb_param :209, ranking and bottom-fraction replacement with reward-gap
gating :296-365, policy 0 never mutated :353-360, per-policy cfg JSON files
:196-206). The decisions and the mutated values are those of the JAX class
under the same cfg, seed and objectives: every draw comes from one
`random.Random(cfg.seed)` in the same order.

The JAX package stacks the population on a leading axis and edits rows; here
the population is a list of P `PolicyTrainState`s, each with its own module
and optimizer, and "replace policy i's weights by policy j's" is a copy on the
device into policy i's tensors. Mutated hyperparameters are written into the
train state's `hparams` dict, which the learner reads on every step.
"""

from __future__ import annotations

import copy
import json
import math
import random
from os.path import join
from typing import Dict, List, Optional

import torch

from sample_factory_tpu_torch.algo.learning import PBT_HPARAMS, PolicyTrainState
from sample_factory_tpu_torch.utils.utils import experiment_dir, log

EPS = 1e-5


def perturb_float(x: float, perturb_amount: float = 1.2, rng: random.Random = random) -> float:
    """Divide or multiply by `perturb_amount`, the direction drawn from `rng`."""
    if rng.random() < 0.5:
        return x / perturb_amount
    return x * perturb_amount


def perturb_exponential_decay(
    x: float, perturb_amount_min=1.01, perturb_amount_max=1.2, rng: random.Random = random
) -> float:
    """For params like gamma: perturb (1 - x) so values near 1 move slowly."""
    amount = rng.uniform(perturb_amount_min, perturb_amount_max)
    return max(EPS, 1.0 - perturb_float(1.0 - x, amount, rng))


SPECIAL_PERTURBATION = {"gamma": perturb_exponential_decay}


def policy_cfg_file(cfg, policy_id: int) -> str:
    return join(experiment_dir(cfg), f"policy_{policy_id:02d}_cfg.json")


def policy_reward_shaping_file(cfg, policy_id: int) -> str:
    return join(experiment_dir(cfg), f"policy_{policy_id:02d}_reward_shaping.json")


class PopulationBasedTraining:
    """Host-side PBT for the population runner. Call `on_training_step(...)` when `due(...)`
    says so; it updates the train states of the policies it replaces or mutates in place."""

    def __init__(self, cfg, num_policies: Optional[int] = None, default_reward_shaping: Optional[Dict] = None):
        self.cfg = cfg
        self.P = num_policies or cfg.num_policies
        # sorted: the order of mutation maps the draws of the generator to the parameters
        self.hparams_to_tune = tuple(sorted(n for n in PBT_HPARAMS if n != "gamma" or cfg.pbt_optimize_gamma))
        self.default_hparams = {name: float(getattr(cfg, name)) for name in PBT_HPARAMS}
        self.policy_hparams: List[Dict[str, float]] = [dict(self.default_hparams) for _ in range(self.P)]
        # reward shaping population (reference policy_reward_shaping, :128-151)
        self.default_reward_shaping = copy.deepcopy(default_reward_shaping)
        self.policy_reward_shaping: List[Optional[Dict]] = [copy.deepcopy(default_reward_shaping) for _ in range(self.P)]
        # (policy_id, shaping) updates the runner must push to the sampler
        self.pending_shaping_updates: List[tuple] = []
        self.last_update = [0] * self.P
        self.rng = random.Random(cfg.seed)

    # --------------------------------------------------------------- mutation

    def _perturb_param(self, value: float, name: str) -> float:
        if self.rng.random() > self.cfg.pbt_mutation_rate:
            return value
        if value != self.default_hparams[name] and self.rng.random() < 0.01:
            return self.default_hparams[name]
        if name in SPECIAL_PERTURBATION:
            new_value = SPECIAL_PERTURBATION[name](value, rng=self.rng)
        else:
            amount = self.rng.uniform(self.cfg.pbt_perturb_min, self.cfg.pbt_perturb_max)
            new_value = perturb_float(float(value), amount, self.rng)
        log.debug("PBT: %s %.6f -> %.6f", name, value, new_value)
        return new_value

    def _perturb_hparams(self, hparams: Dict[str, float]) -> Dict[str, float]:
        out = dict(hparams)
        for name in self.hparams_to_tune:
            out[name] = self._perturb_param(out[name], name)
        return out

    def _perturb_reward_shaping(self, shaping: Optional[Dict]) -> Optional[Dict]:
        """Mutate the numeric leaves of the (possibly nested) shaping dict (reference _perturb, :232-254)."""
        if shaping is None:
            return None

        def perturb_leaf(value, default, name):
            if isinstance(value, dict):
                return {k: perturb_leaf(v, (default or {}).get(k), f"{name}_{k}") for k, v in value.items()}
            if isinstance(value, (tuple, list)):
                return type(value)(
                    self._perturb_shaping_value(v, (default or [v])[i] if default else v, f"{name}_{i}")
                    for i, v in enumerate(value)
                )
            return self._perturb_shaping_value(value, default if default is not None else value, name)

        return {k: perturb_leaf(v, (self.default_reward_shaping or {}).get(k), k) for k, v in shaping.items()}

    def _perturb_shaping_value(self, value, default, name):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return value
        if self.rng.random() > self.cfg.pbt_mutation_rate:
            return value
        if value != default and self.rng.random() < 0.01:
            return default
        amount = self.rng.uniform(self.cfg.pbt_perturb_min, self.cfg.pbt_perturb_max)
        return perturb_float(float(value), amount, self.rng)

    # ------------------------------------------------------------ application

    def _write_hparams_into_state(self, train_states: List[PolicyTrainState], policy_id: int) -> None:
        hp, ts = self.policy_hparams[policy_id], train_states[policy_id]
        ts.hparams = {name: hp[name] for name in ts.hparams}
        # constant-LR runs take the mutated learning rate at once (reference learner.py:400-406)
        if self.cfg.lr_schedule == "constant":
            ts.curr_lr = hp["learning_rate"]

    @torch.no_grad()
    def _replace_weights(self, train_states: List[PolicyTrainState], dst: int, src: int) -> None:
        """Copy policy src's parameters, optimizer state and normalizers into policy dst, on
        the device: the parameters into dst's own tensors, the optimizer state (Adam's
        moments and step; LAMB's count in the param group and its slow weights) and the
        normalizers as fresh copies. dst shares no storage with src afterwards."""
        if dst == src:
            return
        to, frm = train_states[dst], train_states[src]
        to.model.load_state_dict(frm.model.state_dict())  # copy_ into the existing tensors
        # load_state_dict keeps the tensors it is given where device and type already match: copy first
        to.optimizer.load_state_dict(copy.deepcopy(frm.optimizer.state_dict()))

        def copy_rms(own, other):
            return own.load_state_dict({k: v.clone() for k, v in other.state_dict().items()})

        if frm.obs_rms is not None:
            to.obs_rms = {k: copy_rms(to.obs_rms[k], v) for k, v in frm.obs_rms.items()}
        if frm.returns_rms is not None:
            to.returns_rms = copy_rms(to.returns_rms, frm.returns_rms)
        # invalidate the replaced policy's experience in flight
        # (reference learner.py _maybe_load_policy: += max_policy_lag + 1)
        to.train_step += self.cfg.max_policy_lag + 1

    def _save_policy_cfg(self, policy_id: int) -> None:
        with open(policy_cfg_file(self.cfg, policy_id), "w") as f:
            json.dump(self.policy_hparams[policy_id], f, indent=2)
        if self.policy_reward_shaping[policy_id] is not None:
            with open(policy_reward_shaping_file(self.cfg, policy_id), "w") as f:
                json.dump(self.policy_reward_shaping[policy_id], f, indent=2)

    # --------------------------------------------------------------- schedule

    def due(self, env_steps_per_policy: List[int]) -> bool:
        """True when at least one policy is eligible for an update, so that the runner can
        skip the objectives (which sync with the device) on most iterations."""
        if not self.cfg.with_pbt or self.P <= 1:
            return False
        return any(
            steps >= self.cfg.pbt_start_mutation and steps - self.last_update[p] >= self.cfg.pbt_period_env_steps
            for p, steps in enumerate(env_steps_per_policy)
        )

    def on_training_step(self, train_states: List[PolicyTrainState], env_steps_per_policy: List[int],
                         objectives: List[Optional[float]]) -> None:
        """objectives: each policy's windowed target metric (a custom stat or the episode reward)."""
        if not self.cfg.with_pbt or self.P <= 1:
            return
        for policy_id in range(self.P):
            steps = env_steps_per_policy[policy_id]
            if steps < self.cfg.pbt_start_mutation:
                continue
            if steps - self.last_update[policy_id] < self.cfg.pbt_period_env_steps:
                continue
            self._update_policy(train_states, policy_id, objectives)
            self.last_update[policy_id] = steps

    def _update_policy(self, train_states: List[PolicyTrainState], policy_id: int, objectives: List[Optional[float]]) -> None:
        if any(o is None for o in objectives):
            return  # not enough data yet (reference :300-306)

        order = sorted(range(self.P), key=lambda p: objectives[p], reverse=True)
        replace_number = math.ceil(self.cfg.pbt_replace_fraction * self.P)
        best = order[:replace_number]
        worst = order[-replace_number:]

        if policy_id in best:
            return

        replacement = policy_id
        if policy_id in worst:
            candidate = self.rng.choice(best)
            delta = objectives[candidate] - objectives[policy_id]
            delta_relative = abs(delta / (objectives[candidate] + EPS))
            if abs(delta) > self.cfg.pbt_replace_reward_gap_absolute and delta_relative > self.cfg.pbt_replace_reward_gap:
                replacement = candidate
                log.debug("PBT: policy %d weights replaced by %d (gap %.4f)", policy_id, candidate, delta)

        if policy_id == 0:
            # never mutate policy 0 (the reference's baseline policy, :353-360); it may still
            # inherit a better policy's parameters and settings as they are
            self.policy_hparams[policy_id] = dict(self.policy_hparams[replacement])
            self.policy_reward_shaping[policy_id] = copy.deepcopy(self.policy_reward_shaping[replacement])
        else:
            self.policy_hparams[policy_id] = self._perturb_hparams(self.policy_hparams[replacement])
            self.policy_reward_shaping[policy_id] = self._perturb_reward_shaping(self.policy_reward_shaping[replacement])

        self._replace_weights(train_states, policy_id, replacement)
        self._write_hparams_into_state(train_states, policy_id)
        if self.policy_reward_shaping[policy_id] is not None:
            self.pending_shaping_updates.append((policy_id, self.policy_reward_shaping[policy_id]))
        self._save_policy_cfg(policy_id)
