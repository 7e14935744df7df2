"""Running mean/std normalization as state updated by functions.

Counterpart of `sample_factory_tpu/algo/running_mean_std.py` (reference
`sample_factory/algo/utils/running_mean_std.py`: parallel-moments merge
:50-62, normalize/denormalize with clip :64-110, dict variant :113-137).
The state is a small dataclass of tensors on the learner's device; updates
return a new state, as in the JAX package. Accumulators are float32 like the
JAX side's, and `rms_update` takes the same optional mask (:69-120).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

AllSum = Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]]

NORM_EPS = 1e-5
DEFAULT_CLIP = 5.0


@dataclass(frozen=True)
class RunningMeanStdState:
    running_mean: torch.Tensor
    running_var: torch.Tensor
    count: torch.Tensor  # scalar
    clip: float = DEFAULT_CLIP
    eps: float = NORM_EPS
    norm_only: bool = False
    per_channel: bool = False

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"running_mean": self.running_mean, "running_var": self.running_var, "count": self.count}

    def load_state_dict(self, d: Dict[str, torch.Tensor]) -> "RunningMeanStdState":
        dev = self.running_mean.device
        return replace(self, **{k: d[k].to(dev) for k in ("running_mean", "running_var", "count")})


def rms_init(
    input_shape: Sequence[int],
    clip: float = DEFAULT_CLIP,
    eps: float = NORM_EPS,
    norm_only: bool = False,
    per_channel: bool = False,
    device=None,
) -> RunningMeanStdState:
    input_shape = tuple(input_shape)
    shape: Tuple[int, ...] = (input_shape[-1],) if per_channel else input_shape  # channel-last (HWC)
    return RunningMeanStdState(
        running_mean=torch.zeros(shape, device=device),
        running_var=torch.ones(shape, device=device),
        count=torch.ones((), device=device),
        clip=clip,
        eps=eps,
        norm_only=norm_only,
        per_channel=per_channel,
    )


def _reduce_axes(state: RunningMeanStdState, x: torch.Tensor) -> Tuple[int, ...]:
    if state.per_channel:
        return tuple(range(x.dim() - 1))  # all but channel
    return tuple(range(x.dim() - state.running_mean.dim()))


def rms_update(
    state: RunningMeanStdState, x: torch.Tensor, mask: Optional[torch.Tensor] = None, all_sum: AllSum = None
) -> RunningMeanStdState:
    """Merge batch moments into running moments (reference :50-62).

    `mask` (optional) weights samples along the leading batch dims of `x`;
    masked-out samples contribute nothing, and an all-masked batch leaves the
    state unchanged. See `sample_factory_tpu/algo/running_mean_std.py:69-83`.
    With `all_sum` (data parallelism, masked updates only) the batch is every rank's:
    the count, the sum and the squared deviations from the global mean are all-reduced.
    """
    if all_sum is not None and mask is None:
        raise ValueError("a data-parallel rms_update takes a mask")
    reduce = all_sum or (lambda tensors: tensors)
    x = x.float()
    axes = _reduce_axes(state, x)
    if mask is None:
        batch_count = 1.0
        for a in axes:
            batch_count *= x.shape[a]
        batch_count = torch.tensor(batch_count, device=x.device)
        batch_mean = x.mean(dim=axes)
        batch_var = x.var(dim=axes, correction=0)
    else:
        w = mask.float()
        w_full = w.reshape(w.shape + (1,) * (x.dim() - w.dim()))
        extra = 1.0
        for a in axes:
            if a >= w.dim():
                extra *= x.shape[a]
        batch_count, batch_sum = reduce([w.sum() * extra, (w_full * x).sum(dim=axes)])
        safe_count = batch_count.clamp(min=1.0)
        batch_mean = batch_sum / safe_count
        (squares,) = reduce([(w_full * (x - batch_mean).square()).sum(dim=axes)])
        batch_var = squares / safe_count

    delta = batch_mean - state.running_mean
    tot_count = state.count + batch_count
    safe_tot = tot_count.clamp(min=1e-6)
    new_mean = state.running_mean + delta * batch_count / safe_tot
    m_a = state.running_var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta.square() * state.count * batch_count / safe_tot
    new_var = m2 / safe_tot
    if mask is not None:
        empty = batch_count == 0.0
        new_mean = torch.where(empty, state.running_mean, new_mean)
        new_var = torch.where(empty, state.running_var, new_var)
        tot_count = torch.where(empty, state.count, tot_count)
    return replace(state, running_mean=new_mean, running_var=new_var, count=tot_count)


def rms_normalize(state: RunningMeanStdState, x: torch.Tensor) -> torch.Tensor:
    sigma = torch.sqrt(state.running_var + state.eps)
    if state.norm_only:
        return x / sigma
    return ((x - state.running_mean) / sigma).clamp(-state.clip, state.clip)


def rms_denormalize(state: RunningMeanStdState, x: torch.Tensor) -> torch.Tensor:
    sigma = torch.sqrt(state.running_var + state.eps)
    if state.norm_only:
        return x * sigma
    return x.clamp(-state.clip, state.clip) * sigma + state.running_mean


# ------------------------------------------------------------- dict variant

ObsRmsState = Dict[str, RunningMeanStdState]


def obs_rms_init(obs_space, keys_to_normalize: Optional[Sequence[str]] = None, device=None, **kwargs) -> ObsRmsState:
    """One RMS per observation key (reference RunningMeanStdDictInPlace); `action_mask` is never normalized."""
    from sample_factory_tpu_torch.envs.spaces import obs_space_as_dict

    out: ObsRmsState = {}
    for k, space in obs_space_as_dict(obs_space).items():
        if k == "action_mask":
            continue
        if keys_to_normalize is None or k in keys_to_normalize:
            out[k] = rms_init(space.shape, device=device, **kwargs)
    return out


def obs_rms_update(
    state: ObsRmsState, obs: Dict[str, torch.Tensor], mask: Optional[torch.Tensor] = None, all_sum: AllSum = None
) -> ObsRmsState:
    return {k: rms_update(v, obs[k], mask=mask, all_sum=all_sum) for k, v in state.items()}


def obs_rms_normalize(state: ObsRmsState, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (rms_normalize(state[k], v) if k in state else v) for k, v in obs.items()}
