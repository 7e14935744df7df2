"""Static, hashable space specs.

Copy of `sample_factory_tpu/envs/spaces.py`, so that the port's trajectories
and models have the same shapes (reference
`algo/utils/action_distributions.py:14-42` calc_num_actions /
calc_num_action_parameters). Gymnasium spaces convert at the host-env boundary
(`from_gym_space`); an env that declares its spaces in these specs needs no gymnasium.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Discrete:
    n: int


@dataclass(frozen=True)
class Box:
    shape: Tuple[int, ...]
    low: float = -math.inf
    high: float = math.inf
    dtype: str = "float32"


@dataclass(frozen=True)
class TupleSpec:
    spaces: Tuple["Space", ...]


@dataclass(frozen=True)
class DictSpec:
    spaces: Tuple[Tuple[str, "Space"], ...]  # sorted (key, space) pairs; frozen => hashable

    def __getitem__(self, key: str) -> "Space":
        for k, v in self.spaces:
            if k == key:
                return v
        raise KeyError(key)

    def keys(self):
        return [k for k, _ in self.spaces]

    def items(self):
        return list(self.spaces)


Space = object  # union of the above


def make_dict_spec(d: Dict[str, Space]) -> DictSpec:
    return DictSpec(tuple(sorted(d.items())))


def num_actions(space) -> int:
    """Width of the action vector stored in trajectories (reference :14-25)."""
    if isinstance(space, Discrete):
        return 1
    if isinstance(space, Box):
        if len(space.shape) != 1:
            raise ValueError("Box action spaces must be flat; flatten the space")
        return space.shape[0]
    if isinstance(space, TupleSpec):
        return sum(num_actions(s) for s in space.spaces)
    raise NotImplementedError(f"Action space {space!r} not supported")


def num_action_parameters(space) -> int:
    """Width of the raw distribution-parameter vector (reference :28-38)."""
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, Box):
        return int(math.prod(space.shape)) * 2  # mean and log-std per dim
    if isinstance(space, TupleSpec):
        return sum(num_action_parameters(s) for s in space.spaces)
    raise NotImplementedError(f"Action space {space!r} not supported")


def is_continuous_action_space(space) -> bool:
    return isinstance(space, Box)


def action_dtype(space) -> str:
    if isinstance(space, Discrete):
        return "int32"
    if isinstance(space, Box):
        return "float32"
    if isinstance(space, TupleSpec):
        # mixed tuples store everything as float32 and cast discrete components on use
        return "float32" if any(isinstance(s, Box) for s in space.spaces) else "int32"
    raise NotImplementedError(f"Action space {space!r} not supported")


def from_gym_space(space):
    """A gymnasium space as a static spec (the host-env boundary). The port's own specs pass
    through unchanged, so gymnasium is imported only when something else arrives."""
    if isinstance(space, (Discrete, Box, TupleSpec, DictSpec)):
        return space
    import gymnasium as gym

    if isinstance(space, gym.spaces.Discrete):
        return Discrete(int(space.n))
    if isinstance(space, gym.spaces.Box):
        low = float(space.low.min()) if hasattr(space.low, "min") else float(space.low)
        high = float(space.high.max()) if hasattr(space.high, "max") else float(space.high)
        return Box(tuple(int(s) for s in space.shape), low, high, str(space.dtype))
    if isinstance(space, gym.spaces.Tuple):
        return TupleSpec(tuple(from_gym_space(s) for s in space.spaces))
    if isinstance(space, gym.spaces.Dict):
        return make_dict_spec({k: from_gym_space(v) for k, v in space.spaces.items()})
    raise NotImplementedError(f"Gym space {space!r} not supported")


def obs_space_as_dict(space) -> DictSpec:
    """Normalize any observation space to a DictSpec (reference wraps raw spaces into {'obs': ...})."""
    if isinstance(space, DictSpec):
        return space
    return make_dict_spec({"obs": space})
