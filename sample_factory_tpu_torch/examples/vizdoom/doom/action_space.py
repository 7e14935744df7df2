"""Doom composite action spaces.

Copy of `sf_examples_tpu/vizdoom/doom/action_space.py` (reference
`sf_examples/vizdoom/doom/action_space.py`):
each scenario exposes a Tuple of small subspaces (one per button group, first
index of every Discrete subspace = no-op) whose flattened layout must match
the `available_buttons` list of the scenario .cfg file exactly. Continuous
turning is either a Box delta (degrees/frame, scaled) or a `Discretized` bin
space so the policy can stay purely categorical.

The flattening of a composite gym action into the button list VizDoom expects
is a pure function here (`flatten_doom_action`) so it is unit-testable without
the vizdoom package.

The spaces are gymnasium's, as on the JAX side; `envs/spaces.from_gym_space` turns
them into the port's specs (a `Discretized` bin space becomes a `Discrete`). The
module imports without gymnasium, and `flatten_doom_action` also takes the port's
specs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

try:
    import gymnasium as gym
    from gymnasium.spaces import Box, Discrete
except ImportError:  # pragma: no cover
    gym = None


class Discretized(gym.spaces.Discrete if gym else object):
    """A gymnasium Discrete whose n bins map linearly onto [min_action, max_action]: the
    gymnasium form of `envs/discretized.Discretized`, so that it can sit in a gymnasium Tuple."""

    def __init__(self, n: int, min_action: float, max_action: float):
        super().__init__(n)
        self.min_action = min_action
        self.max_action = max_action

    def to_continuous(self, discrete_action):
        step = (self.max_action - self.min_action) / (self.n - 1)
        return self.min_action + discrete_action * step

# degrees-per-frame multiplier applied to Box turning deltas before they are
# handed to TURN_LEFT_RIGHT_DELTA (reference doom_gym.py:258)
DELTA_ACTIONS_SCALING_FACTOR = 7.5


def flatten_doom_action(action_space, actions, delta_scale: float = DELTA_ACTIONS_SCALING_FACTOR) -> List[float]:
    """Convert a (possibly composite) gym action into VizDoom's flat button list.

    Per subspace: Discretized -> one continuous value (the bin center);
    Discrete(n) -> n-1 one-hot button slots (index 0 is the no-op);
    Box -> its values scaled by delta_scale. Matches the semantics of
    reference doom_gym.py:373-409 (_convert_actions).
    """
    if hasattr(action_space, "spaces"):
        spaces = action_space.spaces
    else:
        spaces = (action_space,)
        actions = (actions,)

    flat: List[float] = []
    for subspace, action in zip(spaces, actions):
        # gymnasium's spaces and the port's specs name their classes alike; a Discretized
        # (of either kind) is a Discrete subclass: check it first
        kind = type(subspace).__name__
        if hasattr(subspace, "to_continuous"):
            flat.append(float(subspace.to_continuous(int(action))))
        elif kind == "Discrete":
            one_hot = [0] * (int(subspace.n) - 1)
            if int(action) > 0:
                one_hot[int(action) - 1] = 1
            flat.extend(one_hot)
        elif kind == "Box":
            flat.extend(float(a) * delta_scale for a in np.asarray(action).flatten())
        else:
            raise NotImplementedError(f"Unsupported Doom action subspace: {type(subspace)}")
    return flat


def doom_turn_and_attack_only():
    """Buttons: TURN_LEFT TURN_RIGHT ATTACK."""
    return gym.spaces.Tuple((Discrete(3), Discrete(2)))


def doom_action_space_basic():
    """Buttons: TURN_LEFT TURN_RIGHT MOVE_FORWARD MOVE_BACKWARD."""
    return gym.spaces.Tuple((Discrete(3), Discrete(3)))


def doom_action_space_extended():
    """Buttons: turn L/R, move F/B, strafe L/R, attack."""
    return gym.spaces.Tuple((Discrete(3), Discrete(3), Discrete(3), Discrete(2)))


def doom_action_space():
    """Full deathmatch space with continuous turning (matches the cig/dwango5
    available_buttons order: move F/B, move R/L, weapon prev/next, attack,
    sprint, TURN_LEFT_RIGHT_DELTA)."""
    return gym.spaces.Tuple(
        (
            Discrete(3),
            Discrete(3),
            Discrete(3),
            Discrete(2),
            Discrete(2),
            Box(np.float32(-1.0), np.float32(1.0), (1,)),
        )
    )


def doom_action_space_discretized():
    """Same as doom_action_space but with turning discretized into 11 bins."""
    return gym.spaces.Tuple(
        (
            Discrete(3),
            Discrete(3),
            Discrete(3),
            Discrete(2),
            Discrete(2),
            Discretized(11, min_action=-10.0, max_action=10.0),
        )
    )


def doom_action_space_discretized_no_weap():
    """Battle scenarios: no weapon switching, discretized turning."""
    return gym.spaces.Tuple(
        (
            Discrete(3),
            Discrete(3),
            Discrete(2),
            Discrete(2),
            Discretized(11, min_action=-10.0, max_action=10.0),
        )
    )


def doom_action_space_continuous_no_weap():
    return gym.spaces.Tuple(
        (
            Discrete(3),
            Discrete(3),
            Discrete(2),
            Discrete(2),
            Box(np.float32(-1.0), np.float32(1.0), (1,)),
        )
    )


def doom_action_space_discrete():
    return gym.spaces.Tuple(
        (Discrete(3), Discrete(3), Discrete(3), Discrete(3), Discrete(2), Discrete(2))
    )


def doom_action_space_discrete_no_weap():
    return gym.spaces.Tuple((Discrete(3), Discrete(3), Discrete(3), Discrete(2), Discrete(2)))


def doom_action_space_full_discretized(with_use: bool = False):
    """Dueling/deathmatch space with direct weapon selection (SELECT_WEAPON1-7)
    and 21-bin discretized turning (reference action_space.py:161-193)."""
    spaces: Sequence = [
        Discrete(3),  # noop, forward, backward
        Discrete(3),  # noop, move right, move left
        Discrete(8),  # noop, select weapon 1..7
        Discrete(2),  # noop, attack
        Discrete(2),  # noop, sprint
    ]
    spaces = list(spaces)
    if with_use:
        spaces.append(Discrete(2))  # noop, use
    spaces.append(Discretized(21, min_action=-12.5, max_action=12.5))
    return gym.spaces.Tuple(spaces)
