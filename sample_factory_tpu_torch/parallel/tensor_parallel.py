"""Tensor parallelism over the 'model' mesh axis: the collectives, and the layout of a sharded model.

The JAX package shards a wide layer's parameters over 'model' and lets GSPMD insert the
collectives (`sample_factory_tpu/parallel/mesh.py:69-95`); the math does not change, only the
layout. The port has no partitioner, so the pieces are written by hand:

- `copy_to_model(x)`: identity forward; all-reduce of the gradient over the model group
  backward. A column-parallel layer fed a replicated input computes only its own columns'
  share of the input's gradient.
- `gather_from_model(x, dim)`: all-gather along `dim` forward; this rank's slice of the
  gradient backward. Everything downstream of a gather is computed identically on every rank
  of the model group, so the gradient that comes back is already whole on each of them.
- `gather_param(p, dim)`: the same, for a sharded leaf that must be whole where it is used
  (the recurrent weights `wh` that the RNN kernels take, a wide normaliser scale).

The rollout runs none of these: it acts with a whole copy of the model (`TPLayout.whole_model`),
its shards gathered once a rollout (`TPLayout.gather_into`).

A column-parallel layer is `gather_from_model(layer(copy_to_model(x)))` (`models/model_utils.py`).
Gloo has no reduce-scatter, so none is used. `TPLayout` names the sharded leaves of a model
and turns its train state's shards into the whole state and back, for checkpoints and loads.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's model group: `size` ranks, this one at `index`; a leaf of width W is held
    as columns [index·W/size, (index+1)·W/size) of its width dim."""

    group: Any
    size: int
    index: int

    def __deepcopy__(self, memo):  # a process group is not copied: a model's copy shares it
        return self

    def own(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a whole tensor along `dim`."""
        width = full.shape[dim] // self.size
        return full.narrow(dim, self.index * width, width)


def _gather_parts(x: torch.Tensor, axis: ModelAxis) -> List[torch.Tensor]:
    """The model group's slices of `x`, in rank order. Gloo carries no 16-bit float: such a
    tensor travels as float32, which holds it exactly."""
    send = x.contiguous()
    if send.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(axis.group) == "gloo":
        send = send.float()
    parts = [torch.empty_like(send) for _ in range(axis.size)]
    dist.all_gather(parts, send, group=axis.group)
    return [p.to(x.dtype) for p in parts]


def _all_gather(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The model group's slices of `x`, concatenated along `dim` in rank order."""
    return torch.cat(_gather_parts(x, axis), dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.own(grad, ctx.dim).contiguous(), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, axis)


gather_param = gather_from_model


def full_param(module, name: str) -> torch.Tensor:
    """`module.<name>` whole: gathered over the model axis where `shard_params_tp` sharded it."""
    p = getattr(module, name)
    dim = getattr(module, "tp_dims", {}).get(name)
    return p if dim is None else gather_param(p, dim, module.model_axis)


def flax_width_dim(module, name: str, p: torch.Tensor) -> int:
    """The dim of the torch leaf that holds the JAX rule's width: the last dim of the flax leaf.
    A `weight` that is a flax `kernel` is transposed in the port (`bridge.py`): Dense [out, in],
    Conv OIHW, 1-D Conv OIK, so its width, the output features, is dim 0. The RNN cells' `wi`,
    `wh`, an Embed's table and every 1-D leaf keep the flax layout."""
    if p.ndim >= 2 and name == "weight" and getattr(module, "flax_weight_name", "kernel") == "kernel":
        return 0
    return p.ndim - 1


@dataclass
class TPLayout:
    """The leaves of a model that the 'model' axis shards: parameter name -> the dim split."""

    axis: ModelAxis
    dims: Dict[str, int]

    def param_dims(self, model) -> List[Optional[int]]:
        """The split dim of each of `model.parameters()`, in order (None: replicated)."""
        return [self.dims.get(name) for name, _ in model.named_parameters()]

    def global_sq_norm(self, tensors: List[torch.Tensor], dims: List[Optional[int]]) -> torch.Tensor:
        """Sum of squares of whole leaves, from this rank's: a sharded leaf's squares are summed
        over the model group, a replicated leaf's counted once."""
        sq = [torch.linalg.vector_norm(t).square() for t in tensors]
        sharded = [s for s, d in zip(sq, dims) if d is not None]
        replicated = [s for s, d in zip(sq, dims) if d is None]
        total = torch.stack(sharded).sum()
        dist.all_reduce(total, group=self.axis.group)
        return total + (torch.stack(replicated).sum() if replicated else 0.0)

    def whole_model(self, model):
        """A copy of `model` that holds every leaf whole and runs as without a model axis, without
        gradients: the model the rollout acts with (`Runner._refresh_behavior`), which then makes
        no collective. Its parameters come from `model`'s through `gather_into`."""
        whole = copy.deepcopy(model).requires_grad_(False)
        for module in whole.modules():
            for name, dim in module.__dict__.pop("tp_dims", {}).items():
                p = getattr(module, name)
                shape = list(p.shape)
                shape[dim] *= self.axis.size
                p.data = p.data.new_empty(shape)
            module.__dict__.pop("model_axis", None)
        self.gather_into(whole, model)
        return whole

    def gather_into(self, whole, model) -> None:
        """`whole`'s parameters from the sharded `model`'s: the replicated leaves copied, the shards
        gathered over the model group in one all-gather (on every rank of it)."""
        src, dst = dict(model.named_parameters()), dict(whole.named_parameters())
        sharded = [n for n in src if n in self.dims]
        replicated = [n for n in src if n not in self.dims]
        with torch.no_grad():
            torch._foreach_copy_([dst[n] for n in replicated], [src[n] for n in replicated])
            sizes = [src[n].numel() for n in sharded]
            parts = [part.split(sizes) for part in _gather_parts(torch.cat([src[n].reshape(-1) for n in sharded]), self.axis)]
            for i, n in enumerate(sharded):
                dst[n].copy_(torch.cat([part[i].view_as(src[n]) for part in parts], dim=self.dims[n]))

    def _map_state(self, state: Dict[str, Any], model, fn) -> Dict[str, Any]:
        """`fn(tensor, dim)` on every sharded tensor of a train state's `state_dict()`: the
        model's leaves and the optimizer's per-leaf state (moments, LAMB's slow weights) of the
        same shape; scalars (Adam's step) and the normalizers stay as they are."""
        out = dict(state)
        out["model"] = {k: fn(v, self.dims[k]) if k in self.dims else v for k, v in state["model"].items()}
        dims = self.param_dims(model)
        opt = state["optimizer"]
        out["optimizer"] = {**opt, "state": {
            i: {k: fn(v, dims[i]) if isinstance(v, torch.Tensor) and v.ndim and dims[i] is not None else v for k, v in s.items()}
            for i, s in opt["state"].items()}}
        return out

    def gather_state(self, state: Dict[str, Any], model) -> Dict[str, Any]:
        """The whole train state from this rank's shards: a collective over the model group,
        on every rank of it."""
        return self._map_state(state, model, lambda t, dim: _all_gather(t.detach(), dim, self.axis))

    def slice_state(self, state: Dict[str, Any], model) -> Dict[str, Any]:
        """This rank's shards of a whole train state."""
        return self._map_state(state, model, lambda t, dim: self.axis.own(t, dim).clone())
