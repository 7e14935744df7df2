"""The numbers that decide `correct`, from the program's outputs and the plain reference's on the same recorded inputs.

Each is a widest gap, never a mean, so that one wrong answer shows:
- `loss_gap`: over the followed train calls, |program's reported loss - reference's| / |reference's|;
- `grad_gap`: over the leaves, the gap between the norms of the program's and the reference's Adam first moment after
  the first optimizer step ((1 - beta1) times the first gradient as the optimizer got it), against the reference's
  norm of that leaf or of the median leaf, whichever is larger; where a sample of the first minibatch sits at a PPO
  clip bound to rounding (the reference's `first_moment_norms`), the reference's choice nearest the program's;
- `step_gap`: the same of the parameters' change over the followed train calls, over the leaves whose first gradient
  in the reference is at least a thousandth of the median leaf's (a gradient nought to rounding moves a leaf under
  Adam by round-off alone);
- `value_gap`, `state_gap`: over the followed rollouts, the largest |program - reference| of the values and of the
  sampled envs' recurrent states, against the root mean square of the reference's over that rollout (no `state_gap`
  where the reference's model has no recurrent state);
- `logp_gap`: the largest |program - reference| of the action log-probabilities, in nats;
- `lr_mismatch`: the epochs after which the program's learning rate was not the reference's decision (a KL within 1%
  of a threshold of the KL-adaptive schedule may take either, and the reference takes the program's over), and the
  train calls in which it ran another number of epochs: an exact count, limit 0.
"""

from __future__ import annotations

from typing import Dict

import torch

NUMBERS = ("loss_gap", "grad_gap", "step_gap", "value_gap", "state_gap", "logp_gap", "lr_mismatch")
NEGLIGIBLE_GRAD = 1e-3  # a leaf's first gradient under this share of the median leaf's: left out of step_gap


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    keys = list(keys)
    median = float(torch.tensor([ref[k] for k in keys], dtype=torch.float64).median())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _rms(x: torch.Tensor) -> float:
    return float(x.double().square().mean().sqrt())


def numbers(prog: Dict, ref: Dict, leaves0: Dict[str, torch.Tensor], details: Dict = None) -> Dict[str, float]:
    """prog and ref: {"rollouts": [{values, log_probs, states}], "losses": [float], "first_moment": {leaf: tensor},
    "leaves": {leaf: tensor}}, ref also "lr_mismatches" (the reference judged prog's schedule); leaves0 the parameters both started from. `details`, where given, gets each number's
    parts: the gap of every leaf and of every followed iteration."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    g_prog, g_ref = _norms(prog["first_moment"]), _norms(ref["first_moment"])
    grads = min((_leaf_gaps(g_prog, choice, choice) for choice in ref.get("first_moment_norms") or [g_ref]),
                key=lambda gaps: max(gaps.values()))
    median_grad = float(torch.tensor(list(g_ref.values()), dtype=torch.float64).median())
    moving = [k for k, g in g_ref.items() if g >= NEGLIGIBLE_GRAD * median_grad]
    d_prog = _norms({k: prog["leaves"][k].double() - leaves0[k].double() for k in moving})
    d_ref = _norms({k: ref["leaves"][k].double() - leaves0[k].double() for k in moving})
    steps = _leaf_gaps(d_prog, d_ref, moving)
    pairs = list(zip(prog["rollouts"], ref["rollouts"]))
    values = [float((p["values"] - r["values"]).abs().max()) / max(_rms(r["values"]), 1e-30) for p, r in pairs]
    states = [float((p["states"] - r["states"]).abs().max()) / max(_rms(r["states"]), 1e-30) for p, r in pairs
              if r["states"].numel()]
    logps = [float((p["log_probs"] - r["log_probs"]).abs().max()) for p, r in pairs]
    if details is not None:
        details.update(loss=losses, grad=grads, step=steps, value=values, state=states, logp=logps,
                       left_out=sorted(set(g_ref) - set(moving)), grad_choices=len(ref.get("first_moment_norms") or [0]))
    out = {"loss_gap": max(losses), "grad_gap": max(grads.values()), "step_gap": max(steps.values()),
           "value_gap": max(values), "state_gap": max(states, default=None), "logp_gap": max(logps),
           "lr_mismatch": float(ref["lr_mismatches"])}
    return {k: v for k, v in out.items() if v is not None}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite, or has no limit set, fails)."""
    return all(limits[k] is not None and values[k] == values[k] and values[k] <= limits[k] for k in limits)
