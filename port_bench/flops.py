"""Model flops, counted from a configuration's widths alone by its reference module (`forward_flops_per_sample`;
`reference/model.py`'s: 2 x the multiply-adds of every product of one forward of one sample, the encoder's layers,
the recurrent cell's input and recurrent products, the critic and the action head). Nothing is read from the
program's modules, and nothing recomputed is counted."""

from __future__ import annotations

from port_bench import reference


def forward_flops_per_sample(model) -> int:
    return reference.of(model).forward_flops_per_sample(model)


def model_flops_per_env_step(model, rollout: int, epochs: float) -> float:
    """A rollout forward, the bootstrap value's share (1 / rollout) and a forward and backward (3 forwards) an epoch."""
    return forward_flops_per_sample(model) * (1.0 + 1.0 / rollout + 3.0 * epochs)
