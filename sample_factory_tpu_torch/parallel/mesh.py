"""The device mesh of a run: which rank this process is, and the slice of the envs it steps.

Counterpart of `sample_factory_tpu/parallel/mesh.py`. The JAX package builds a mesh over
all devices and lets GSPMD place the envs on the 'data' axis, replicate the train state
and turn the learner's reductions into all-reduces. The port runs one process per device
in a `torch.distributed` process group (`parallel/multihost.py`): rank r of R steps envs
[r·N/R, (r+1)·N/R) of the N that `--num_envs` names, holds a full replica of the train
state, and the learner reduces across ranks by hand (`algo/learning.py`), so that R ranks
compute what one rank with N envs computes.

Tensor parallelism (`--mesh_model=M > 1`, `shard_params_tp`): the world of W = D x M ranks
is laid out as `make_mesh` reshapes the JAX devices (:23-33): rank r sits at data index
r // M and model index r % M. A model group (M consecutive ranks) steps the same envs and
holds one replica of the train state between them, each wide leaf split over its ranks
(`parallel/tensor_parallel.py`); a data group (the D ranks of one model index) reduces the
learner's sums, as the ranks of a data-parallel run do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from sample_factory_tpu_torch.parallel.multihost import broadcast_from_primary, has_group, local_rank, process_index, world_size
from sample_factory_tpu_torch.parallel.tensor_parallel import ModelAxis, TPLayout, flax_width_dim
from sample_factory_tpu_torch.utils.utils import log, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the run. `distributed` says whether a process group exists:
    only then do the runners and the learner call collectives (a world of 1 included).
    `data_group` and `model_group` are the process groups of this rank's data and model
    groups; None stands for the whole world (no model axis) or for no group at all."""

    world: int
    rank: int
    data: int
    model: int
    device: torch.device
    distributed: bool
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model_group, self.model, self.model_index)


@dataclass(frozen=True)
class EnvShard:
    """This rank's rows [start, stop) of the env axis of `total` envs."""

    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start


def mesh_axes(cfg, world: int) -> Tuple[int, int]:
    """(data, model) from --mesh_data/--mesh_model over `world` devices; -1 for data means
    all of them over the model axis (`make_mesh` :23-33)."""
    model = getattr(cfg, "mesh_model", 1) if cfg is not None else 1
    data = getattr(cfg, "mesh_data", -1) if cfg is not None else -1
    if data <= 0:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover {world} devices; set --mesh_data/--mesh_model")
    return data, model


def _rank_device(cfg) -> torch.device:
    """cuda:LOCAL_RANK under a group on --device=gpu: never the CPU, never another card."""
    device = resolve_device(cfg)
    if device.type != "cuda":
        return device
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={index} but this host has {torch.cuda.device_count()} CUDA device(s)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _axis_groups(data: int, model: int, rank: int):
    """(data group, model group) of `rank`. Every rank creates every group, in one order, also
    those it is not in: `new_group` is a collective of the whole world."""
    data_groups = [dist.new_group(list(range(m, data * model, model))) for m in range(model)]
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model))) for d in range(data)]
    return data_groups[rank % model], model_groups[rank // model]


def make_mesh(cfg=None) -> Mesh:
    distributed = has_group()
    world = world_size()
    data, model = mesh_axes(cfg, world)
    device = _rank_device(cfg) if distributed else resolve_device(cfg)
    rank = process_index()
    groups = _axis_groups(data, model, rank) if model > 1 else (None, None)
    return Mesh(world=world, rank=rank, data=data, model=model, device=device, distributed=distributed,
                data_group=groups[0], model_group=groups[1])


def num_data_shards(mesh) -> int:
    return mesh.data if mesh is not None else 1


def shard_env_axis(mesh: Mesh, num_envs: int) -> EnvShard:
    """The rank's slice of the env axis (`shard_env_axis` :45-62 places it on the 'data' axis):
    by data index, so that the ranks of a model group step the same envs."""
    shards = num_data_shards(mesh)
    if num_envs % shards:
        raise ValueError(f"num_envs ({num_envs}) must divide over {shards} data shards")
    per_rank = num_envs // shards
    return EnvShard(mesh.data_index * per_rank, (mesh.data_index + 1) * per_rank, num_envs)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def replicate_tree(train_state, mesh: Mesh) -> None:
    """Rank 0's train state on every rank, in place: the parameters and buffers, the
    optimizer's state, the normalizers, the learning rate, the train step and the PBT
    hyperparameters. It travels as rank 0's checkpoint payload, so that a rank that restored
    no checkpoint (an empty optimizer state, step 0) or another one takes rank 0's all the
    same. It runs before `shard_train_state`: the state travels whole, and sharding follows
    replication. No-op without a group."""
    if not mesh.distributed:
        return
    if train_state.tp is not None:
        raise ValueError("replicate_tree takes a whole train state: shard it after replicating it")
    payload = broadcast_from_primary(_to_cpu(train_state.state_dict()) if mesh.rank == 0 else None)
    if mesh.rank != 0:
        train_state.load_state_dict(payload)


# modules whose forward takes their sharded leaves: column-parallel over every leaf (Dense, Conv, the
# RNN cells), or gathering the leaf where it is used (`tensor_parallel.full_param`)
TAKES_MODEL_SHARDS = ("columns", "gathered")


def shard_params_tp(model, mesh: Mesh, min_width: int = 512) -> Optional[TPLayout]:
    """Tensor parallelism: keep this rank's shard of every wide leaf of `model`, in place.

    The JAX rule (`shard_params_tp` :69-95), on the width of each leaf in the flax layout
    (`tensor_parallel.flax_width_dim`): a leaf whose width is at least `min_width` and divides
    by the model axis is split along it, everything else replicated. The shard is sliced out of
    the whole parameters that every rank built from the same seed, so that the sharded model
    starts where the replicated one does. Each module that holds a shard learns the model axis
    and its split leaves (`model_axis`, `tp_dims`); a module that cannot take shards raises.
    Returns the layout, or None where the mesh has no model axis or no leaf is wide enough (the
    model then runs replicated on the model group's ranks, as under GSPMD)."""
    if mesh.model <= 1:
        return None
    axis = mesh.model_axis
    dims = {}
    for prefix, module in model.named_modules():
        own = {}
        for name, p in module.named_parameters(recurse=False):
            dim = flax_width_dim(module, name, p) if p.ndim else None
            if dim is not None and p.shape[dim] >= min_width and p.shape[dim] % axis.size == 0:
                own[name] = dim
        if not own:
            continue
        takes = getattr(module, "takes_model_shards", None)
        if takes not in TAKES_MODEL_SHARDS or (takes == "columns" and len(own) != len(module._parameters)):
            raise NotImplementedError(
                f"{type(module).__name__} ({prefix}) holds {sorted(own)}, which --mesh_model={axis.size} shards at "
                f"--tp_min_layer_width={min_width}, but its forward does not take shards"
            )
        with torch.no_grad():
            for name, dim in own.items():
                p = getattr(module, name)
                p.data = axis.own(p.data, dim).clone()
                dims[f"{prefix}.{name}" if prefix else name] = dim
        module.model_axis, module.tp_dims = axis, own
    if not dims:
        log.warning("--mesh_model=%d: no leaf is %d wide and divisible by %d; the model runs replicated", axis.size, min_width, axis.size)
        return None
    log.info("--mesh_model=%d: %d leaves sharded over the 'model' axis, this rank holds part %d: %s", axis.size, len(dims),
             axis.index, ", ".join(sorted(dims)))
    return TPLayout(axis, dims)


def shard_train_state(train_state, mesh: Mesh, min_width: int = 512) -> None:
    """`shard_params_tp` on a whole train state, in place: the model's leaves, then the
    optimizer's state of each (moments, LAMB's slow weights), sliced alike; LAMB learns which
    leaves are shards, whose norms it takes over the model group. The layout goes into
    `train_state.tp`."""
    whole = train_state.optimizer.state_dict()
    layout = shard_params_tp(train_state.model, mesh, min_width)
    if layout is None:
        return
    train_state.tp = layout
    train_state.optimizer.load_state_dict(layout.slice_state({"model": {}, "optimizer": whole}, train_state.model)["optimizer"])
    if hasattr(train_state.optimizer, "model_shards"):
        train_state.optimizer.model_shards = (layout.axis, layout.param_dims(train_state.model))
